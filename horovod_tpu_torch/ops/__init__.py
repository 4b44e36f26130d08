"""Hand-written CUDA kernels of horovod_tpu_torch, each beside its plain
PyTorch version (counterpart of ``horovod_tpu/ops``)."""
