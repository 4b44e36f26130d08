"""Elastic rendezvous: live slot lookups backed by the driver.

Reference: horovod/runner/elastic/rendezvous.py — in an
elastic job the ``rank_and_size`` scope must not be a static table: each
GET both *registers the worker as ready* for the current generation and
returns its freshly computed assignment; PUTs to ``worker_addresses``
register the worker's notification service with the driver.
"""

import pickle

from ..runner.rendezvous import RendezvousServer
from ..sdc.report import SDC_SCOPE, decode_report
from .heartbeat import HEARTBEAT_SCOPE
from .preemption import PREEMPT_SCOPE, decode_notice
from .worker import PUT_WORKER_ADDRESSES

GET_RANK_AND_SIZE = "rank_and_size"


def _slot_payload(s) -> bytes:
    return (f"{s.rank},{s.size},{s.local_rank},{s.local_size},"
            f"{s.cross_rank},{s.cross_size}").encode()


def attach_elastic_handlers(rendezvous: RendezvousServer, driver) -> None:
    """Wire an ElasticDriver into a running RendezvousServer."""

    def get_rank_and_size(key: str):
        host, _, local_rank = key.rpartition(":")
        slot = int(local_rank)
        driver.record_ready(host, slot)
        info = driver.get_slot_info(host, slot)
        return _slot_payload(info)

    def put_worker_addresses(key: str, value: bytes):
        host, _, local_rank = key.rpartition(":")
        addresses, secret_key = pickle.loads(value)
        driver.register_worker_server(host, int(local_rank), addresses,
                                      secret_key)

    rendezvous.add_handler(GET_RANK_AND_SIZE, get_rank_and_size)
    rendezvous.add_put_handler(PUT_WORKER_ADDRESSES, put_worker_addresses)
    record_heartbeat = getattr(driver, "record_heartbeat", None)
    if record_heartbeat is not None:   # unit-test driver doubles may lack it
        rendezvous.add_put_handler(HEARTBEAT_SCOPE, record_heartbeat)
    # liveness is only meaningful live: never journal or snapshot beats
    rendezvous.ephemeral_scopes.add(HEARTBEAT_SCOPE)

    record_notice = getattr(driver, "record_preemption_notice", None)
    if record_notice is not None:

        def put_preemption_notice(key: str, value: bytes):
            # One channel for every producer: the worker-side fault kind,
            # an operator's HTTP PUT (curl .../preempt/<host>), and
            # journal replay all route here. persist=False — this PUT is
            # already in the (journaled, NOT ephemeral) store; a drain
            # must survive a coordinator restart.
            grace, ts = decode_notice(value)
            record_notice(key, grace, ts=ts, persist=False)

        rendezvous.add_put_handler(PREEMPT_SCOPE, put_preemption_notice)

    record_sdc = getattr(driver, "record_sdc_report", None)
    if record_sdc is not None:

        def put_sdc_report(key: str, value: bytes):
            # Same one-channel shape as the preemption notice: the
            # worker-side SDC policy and an operator's HTTP PUT
            # (curl .../sdc/<host>) both route here. persist=False —
            # the PUT is already in the journaled store, so a restarted
            # coordinator replays the quarantine on its own.
            kind, strikes, ts = decode_report(value)
            record_sdc(key, kind, strikes=strikes, ts=ts, persist=False)

        rendezvous.add_put_handler(SDC_SCOPE, put_sdc_report)
