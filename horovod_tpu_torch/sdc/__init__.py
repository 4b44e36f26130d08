"""Silent-data-corruption plane of the port: only the report channel so far.

``report.py`` is a copy of ``horovod_tpu/sdc/report.py``: the JSON payload
of the journaled ``sdc`` rendezvous scope, which the elastic driver and
the rendezvous handlers decode and a worker encodes. The step guard, the
parameter fingerprints and the quarantine policy (the JAX package's
``guard.py``, ``fingerprint.py`` and ``policy.py``) wait (ROADMAP A2).
"""

from .report import SDC_SCOPE, decode_report, encode_report  # noqa: F401
