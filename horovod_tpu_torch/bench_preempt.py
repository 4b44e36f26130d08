"""Times the generation plane's preemption wave on one GPU, for comparing
two trees of the port on one card in one call.

    python3 horovod_tpu_torch/bench_preempt.py [--blocks N]
        [--deadline-ms MS] [--label L]

imports ``horovod_tpu_torch`` from ``sys.path``, so with
``PYTHONPATH=<other checkout>`` it times that checkout's package with
this script. The wave is ``chip_smoke.py``'s: the default
TransformerConfig (weights from seed 0), 32 prompts of 256-1024 tokens
(numpy seed 0), 64 greedy tokens each, all submitted at once to a
``GenerationEngine`` of N KV blocks (160: it preempts), with no
per-token deadline unless one is given. Prints one JSON line: the
package's path, the card, the wave's seconds, the preemptions, and the
longest wait any sequence had for a token (from its submission to its
first token, or between two tokens), the span a per-token deadline is
held against.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=160)
    ap.add_argument("--deadline-ms", type=float, default=0.0)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_preempt: needs a CUDA device")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.serving.generation import GenerationEngine
    cfg = TransformerConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = {n: p.detach() for n, p in Transformer(
        cfg, device="cuda", generator=gen).named_parameters()}
    rng = np.random.RandomState(0)
    lengths = rng.randint(256, 1025, 32)
    prompts = [rng.randint(0, cfg.vocab_size, (int(n),)).tolist()
               for n in lengths]
    emitted = {}

    def on_step(phase, ids):
        now = time.perf_counter()
        for i in ids:
            s = seqs.get(i)
            if s is not None and len(s.generated) > len(emitted[i]) - 1:
                emitted[i].append(now)
    seqs = {}
    key = "hvd_tpu_gen_preemptions_total"
    before = metrics.snapshot().get(key, 0)
    with GenerationEngine(Transformer(cfg, device="meta"), params=params,
                          num_blocks=args.blocks,
                          deadline_ms=args.deadline_ms,
                          reload_poll_seconds=0, on_step=on_step) as eng:
        t0 = time.perf_counter()
        for p in prompts:
            s = eng.submit(p, max_tokens=64)
            emitted[s.id] = [time.perf_counter()]
            seqs[s.id] = s
        for s in list(seqs.values()):
            eng.result(s, timeout=600)
        wave_s = time.perf_counter() - t0
    preemptions = metrics.snapshot().get(key, 0) - before
    waits = {i: max(b - a for a, b in zip(ts, ts[1:]))
             for i, ts in emitted.items() if len(ts) > 1}
    worst = max(waits, key=waits.get)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "package": hvd.__file__,
                      "card": smi, "num_blocks": args.blocks,
                      "wave_s": wave_s, "preemptions": preemptions,
                      "max_token_wait_s": waits[worst],
                      "max_token_wait_seq": worst,
                      "first_token_wait_s_by_seq": [
                          emitted[i][1] - emitted[i][0]
                          for i in sorted(emitted)
                          if len(emitted[i]) > 1]}), flush=True)


if __name__ == "__main__":
    main()
