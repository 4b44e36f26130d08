"""The comparison that decides ``correct`` for a training cell.

Set-up drives the program's training step from the seed through its
first three steps, through the window's own call, on three batches whose
rows all differ, and reads:

- the loss of each step;
- each leaf's norm of the first gradient as the optimizer got it, worked
  out from the optimizer's state after one step;
- each leaf's norm of its change over the three steps, read before a
  fourth step moves it;
- for a model with running statistics, each buffer's norm of its change
  over the three steps.

The plain reference follows the same three steps from the same weights
and batches in float32. The numbers compared are gaps between the two
readings, each against a limit of its own (``limits/<workload>.json``):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: over the leaves, the largest gap between the program's
  gradient norm and the reference's, against the reference's norm of that
  leaf or of the median leaf, whichever is larger (some gradients are all
  but zero);
- ``change_gap``: the same of the change norms, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's (a
  leaf whose gradient is nought to rounding moves under Adam by
  round-off alone);
- ``stats_gap``: the same of the running statistics' change norms;
- each of the three above over its median leaf (``grad_gap_median``
  ...): steadier numbers, for a cell whose worst leaf swings from seed
  to seed by the nature of the model;
- ``ranks_differ``, on more than one chip: the number of (rank, leaf)
  pairs whose parameters after the window differ from rank 0's (each
  leaf's sum and sum of squares in float64, compared exactly): an
  exchange that gives every rank the same average keeps it at 0.

A cell compares the numbers that its limits file lists, each against its
limit. A gap that is not a number (a loss that is not finite) fails.
"""

import math
import statistics
from typing import Dict, List, Optional

#: leaves whose reference gradient norm is under this share of the
#: median leaf's are left out of ``change_gap``
MOVED_SHARE = 1e-3


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """max over leaves of |prog - ref| / max(ref, the median ref)."""
    if set(prog) != set(ref):
        raise ValueError(f"leaves differ: {sorted(set(prog) ^ set(ref))}")
    med = statistics.median(ref.values())
    return _largest(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
                    for n in ref)


def _largest(values) -> float:
    """The largest value, or inf where any is not a finite number."""
    xs = list(values)
    return max(xs) if all(math.isfinite(x) for x in xs) else math.inf


def median_leaf(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The median over leaves of |prog - ref| / max(ref, the median ref):
    the gap of a typical leaf, steadier than the worst one."""
    med = statistics.median(ref.values())
    xs = [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in ref]
    if not all(math.isfinite(x) for x in xs):
        return math.inf
    return statistics.median(xs)


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """Every number the check can compare, from two readings (see the
    module docstring): dicts with ``losses`` (a list), ``grad``,
    ``change`` and ``stats`` (leaf name -> norm). Besides the worst
    leaf's gap of each per-leaf number, its median leaf's
    (``<name>_median``)."""
    out = {"loss_gap": _largest(abs(a - b) / abs(b) for a, b in
                                zip(prog["losses"], ref["losses"]))}
    med = statistics.median(ref["grad"].values())
    moved = [n for n, g in ref["grad"].items() if g >= MOVED_SHARE * med]
    pairs = {"grad": (prog["grad"], ref["grad"]),
             "change": ({n: prog["change"][n] for n in moved},
                        {n: ref["change"][n] for n in moved})}
    if ref.get("stats"):
        pairs["stats"] = (prog["stats"], ref["stats"])
    for key, (p, r) in pairs.items():
        out[f"{key}_gap"] = worst_leaf(p, r)
        out[f"{key}_gap_median"] = median_leaf(p, r)
    return out


def ranks_differ(sums: List[List[List[float]]]) -> int:
    """How many (rank, leaf) checksums differ from rank 0's; ``sums`` is
    per rank, per leaf, [sum, sum of squares]."""
    first = sums[0]
    return sum(leaf != ref for other in sums[1:]
               for leaf, ref in zip(other, first)) + sum(
        abs(len(other) - len(first)) for other in sums[1:])


def judge(found: Dict[str, float], limits: Optional[dict]):
    """(correct, [(name, value, limit)]) over the numbers the cell
    compares: those its limits file lists. A cell without limits is not
    correct, nor is one whose listed number was not read."""
    rows: List[tuple] = []
    ok = bool(limits)
    for name, entry in (limits or {}).items():
        value = found.get(name, math.nan)
        rows.append((name, value, entry["limit"]))
        if not value <= entry["limit"]:
            ok = False
    return ok, rows
