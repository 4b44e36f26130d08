"""What the card did during a window, as ``nvidia-smi`` reads it: its SM
clock, power draw and temperature, sampled every half second by one
``nvidia-smi`` process that runs beside the window and is stopped after
it. A card below its boost clock, at its power limit or hot, runs the
same steps slower; the samples say whether a slow run was such a run.
Where ``nvidia-smi`` is missing (the CPU tests) nothing is sampled."""

import statistics
import subprocess
from typing import Optional

FIELDS = ("clocks.sm", "power.draw", "temperature.gpu")


class Sampler:
    """``with Sampler(index) as s: ...``; then ``s.summary()``."""

    def __init__(self, index: int):
        self.index = index
        self.proc: Optional[subprocess.Popen] = None
        self.out = ""

    def __enter__(self) -> "Sampler":
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={','.join(FIELDS)}",
                 "--format=csv,noheader,nounits", "-i", str(self.index),
                 "-lms", "500"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc) -> None:
        if self.proc is None:
            return
        self.proc.terminate()
        try:
            self.out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.out, _ = self.proc.communicate()

    def summary(self) -> Optional[dict]:
        """{field: [min, mean, max]} over the samples, or None."""
        rows = []
        for line in self.out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            try:
                rows.append([float(p) for p in parts])
            except ValueError:
                continue
        rows = [r for r in rows if len(r) == len(FIELDS)]
        if not rows:
            return None
        out = {"samples": len(rows)}
        for i, name in enumerate(FIELDS):
            col = [r[i] for r in rows]
            out[name] = [min(col), statistics.fmean(col), max(col)]
        return out
