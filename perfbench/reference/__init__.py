"""Plain PyTorch references of the benchmark's configurations.

Written from the published descriptions in float32, with TF32 off, and
independent of the program: nothing here imports ``horovod_tpu_torch``,
``horovod_tpu`` or ``jax``. The benchmark makes the weights and the data
from the seed and hands the same values to the reference and to the
program; the reference takes nothing that the program made.

One module per configuration family, named as the family
(``reference/<family>.py``). Each model is functional: a dict of leaves
by the program's parameter names in, a summed loss (and, for the CNN, the
batch statistics) out; ``loss_and_grads`` gives the mean loss, the
gradients and the batch statistics of one global batch, and
``update_running`` moves the running statistics.
``precision.py`` holds the control's lower precision, and ``optim.py``
the optimizers written out.
"""

import contextlib

import torch


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions while the reference
    computes in float32; the settings the process had come back after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
