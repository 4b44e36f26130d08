"""One rank of a gloo world of horovod_tpu_torch for the telemetry tests
(jax-free). Run with the ``HVD_TPU_*`` world env, a rendezvous KV store in
``HVD_TPU_RENDEZVOUS_ADDR``/``_PORT``, ``HVD_TPU_SCHEDULE_CHECK=1``, short
stall deadlines and ``HVD_TPU_FAULT_SPEC=drill.schedule.skip:error:rank=1``:

    python tests/torch_port_telemetry_worker.py <out_dir>

1. metrics: the collective mix of ``tests/metrics_worker.py`` (three
   allreduces under one name, an allgather), a rank-local skew counter
   bumped ``rank`` times, then ``metrics_allgather_summary()``; rank 0
   scrapes its own ``/metrics`` endpoint when ``HVD_TPU_METRICS_PORT`` is
   set;
2. the seeded schedule divergence of ``tests/schedule_divergence_worker
   .py``, with the consistency exchange off: rank 1 skips ``dense_1``, so
   its ``dense_2`` pairs with rank 0's ``dense_1`` and rank 0's ``dense_2``
   waits for a peer that never comes, until the stall inspector raises a
   StallError that names the divergence.

Each rank writes ``rank<r>.json`` to ``out_dir`` (its snapshot, the
summary, the scrape, its ledger and the StallError's message) and leaves
with ``os._exit``: the world is wedged by design.
"""

import json
import os
import sys
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import _schedule, faults, metrics  # noqa: E402
from horovod_tpu_torch.exceptions import StallError  # noqa: E402

_SKIP = faults.FaultPoint("drill.schedule.skip")


def main(out_dir: str) -> None:
    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    out = {"rank": rank, "size": size}

    for _ in range(3):
        hvd.allreduce(torch.ones(4), op=hvd.Sum, name="m.loop")
    hvd.allgather(torch.ones(2), name="m.gather")
    skew = metrics.counter("test_rank_skew_total",
                           "per-rank skew for the summary test")
    for _ in range(rank):
        skew.inc()
    out["snapshot"] = hvd.metrics_snapshot()
    out["summary"] = hvd.metrics_allgather_summary()
    port = int(os.environ.get("HVD_TPU_METRICS_PORT", "0"))
    if port and rank == 0:
        out["scrape"] = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()

    # the drill: consistency off, as the reference's silent-deadlock mode
    os.environ["HVD_TPU_CHECK_CONSISTENCY"] = "0"
    hvd.allreduce(torch.ones(3), name="warm")
    try:
        _SKIP.fire()
        hvd.allreduce(torch.ones(3), name="dense_1")
        out["skipped"] = False
    except faults.InjectedFault:
        out["skipped"] = True
    led = _schedule.ledger()
    try:
        hvd.allreduce(torch.ones(3), name="dense_2")
    except StallError as e:
        out["stall"] = str(e)
        out["ledger"] = led.snapshot()
        _write(out_dir, out)
        led._kv_client().put("schedule", "diagnosed", b"1")
        time.sleep(1)
        os._exit(0)
    led.flush()
    out["ledger"] = led.snapshot()
    _write(out_dir, out)
    # stay up until the wedged peer has fetched the ledgers
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if led._kv_client().get("schedule", "diagnosed"):
            break
        time.sleep(0.2)
    os._exit(0)


def _write(out_dir: str, out: dict) -> None:
    path = os.path.join(out_dir, f"rank{out['rank']}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


if __name__ == "__main__":
    main(sys.argv[1])
