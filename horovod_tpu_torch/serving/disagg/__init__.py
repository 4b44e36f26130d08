"""Disaggregated prefill/decode serving: the pool-split fleet's
KV-block shipping layer (counterpart of ``horovod_tpu/serving/disagg``).

A fleet can split into a **prefill pool** and a
**decode pool** (``HVD_TPU_DISAGG_ROLE=prefill|decode``; the default
``colocated`` keeps every replica serving both phases). A prefill replica runs chunked prefill into its paged cache
and retires the sequence with its full blocks parked content-indexed;
the router then *offers* that content-addressed manifest to the chosen
decode replica (``POST /v1/kv/offer``), which pulls only the blocks it
doesn't already hold (``POST /v1/kv/fetch``, :mod:`.wire` packing) and
registers them straight into its :class:`BlockAllocator` index — so
the sequence admits with **zero prefill debt**, and a warm shared
prefix moves zero bytes. Transfer failure at any point (including the
``disagg.transfer`` fault site) degrades to decode-side re-prefill
with bit-identical output.

:mod:`.wire` — manifests + packed payload codec;
:mod:`.transfer` — decode-side pull orchestration, fault site, metrics.
"""

from .transfer import fetch_blocks, pull_and_import
from .wire import pack_blocks, prompt_manifest, unpack_blocks

__all__ = ["fetch_blocks", "pull_and_import", "pack_blocks",
           "prompt_manifest", "unpack_blocks"]
