"""Exception types for horovod_tpu_torch.

A copy of ``horovod_tpu/exceptions.py`` (the port imports nothing of the
JAX package), itself the counterpart of the reference's error surface
(horovod/common/exceptions.py and the DUPLICATE_NAME_ERROR /
shape-mismatch errors raised by the C++ controller, controller.cc).
"""


class HorovodInternalError(RuntimeError):
    """Internal error raised when a collective fails mid-flight.

    In elastic mode this triggers state restore + re-initialization
    (reference: horovod/common/exceptions.py:21, common/elastic.py:147-168).
    """


class HostsUpdatedInterrupt(Exception):
    """Raised in elastic mode when cluster membership changed.

    The current batch results are kept (no rollback) and the job
    re-initializes on the new set of hosts
    (reference: horovod/common/exceptions.py:26-34).
    """

    def __init__(self, skip_sync=False):
        super().__init__()
        self.skip_sync = skip_sync


class TensorValidationError(ValueError):
    """A submitted tensor failed validation against the named-tensor table.

    Covers the reference controller's error responses: duplicate in-flight
    name, mismatched dtype/shape/op across ranks
    (reference: horovod/common/controller.cc:378-611, tensor_queue.cc
    DUPLICATE_NAME_ERROR).
    """


class DuplicateNameError(TensorValidationError):
    """Same tensor name submitted while a prior submission is in flight."""


class NotInitializedError(RuntimeError):
    """An API that requires init() was called before init()."""

    def __init__(self, what="horovod_tpu_torch"):
        super().__init__(
            f"{what} has not been initialized; call "
            f"horovod_tpu_torch.init() first.")


class StallError(HorovodInternalError):
    """Raised (optionally) by the stall inspector after the shutdown deadline.

    Subclasses :class:`HorovodInternalError` so the elastic retry loop
    treats a stalled collective (usually a dead or wedged peer) as a
    recoverable fault: restore committed state and re-initialize
    (reference: stall shutdown aborts the job, stall_inspector.cc:31-90;
    elastic recovery then restarts it — here the two compose directly).
    """
