"""Cross-process synchronized batch normalization (counterpart of the JAX
package's torch frontend, ``horovod_tpu/torch/sync_batch_norm.py``, and
of ``sync_batch_norm_stats`` in ``horovod_tpu/sync_batch_norm.py``).

:class:`SyncBatchNorm` normalizes with the statistics of the GLOBAL
batch: its autograd Function allreduces the per-channel (sum, sum of
squares, count) in forward and (sum dy, sum dy·x̂) in backward
(reference: horovod/torch/sync_batch_norm.py):

  forward:  mean, var from the allreduced sums
  backward: dx = (dy - mean(dy) - x̂·mean(dy·x̂)) · invstd · w

with both means over the global batch. Unlike the JAX package's frontend,
it runs this path in training mode in a world of one as well (the
allreduces go through the wire there too), so its size-1 output equals
``nn.BatchNorm``'s only up to fp32 rounding: the variance is
E[x²] - E[x]², not the two-pass variance.
"""

from typing import Tuple

import torch

from . import collectives as _c


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input, weight, bias, eps, process_set):
        dims = [0] + list(range(2, input.dim()))
        c = input.size(1)
        f32 = input.float()
        count = torch.full((1,), float(input.numel() // c),
                           device=input.device)
        glob = _c.allreduce(torch.cat([f32.sum(dims), (f32 * f32).sum(dims),
                                       count]),
                            op=_c.Sum, name="sync_bn.fwd_stats",
                            process_set=process_set)
        g_sum, g_sqsum, g_count = glob[:c], glob[c:2 * c], glob[2 * c]
        mean = g_sum / g_count
        var = g_sqsum / g_count - mean * mean
        invstd = torch.rsqrt(var + eps)
        shape = [1, c] + [1] * (input.dim() - 2)
        xhat = (f32 - mean.view(shape)) * invstd.view(shape)
        out = xhat
        if weight is not None:
            out = out * weight.float().view(shape)
        if bias is not None:
            out = out + bias.float().view(shape)
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.g_count = g_count
        ctx.process_set = process_set
        ctx.has_bias = bias is not None
        ctx.mark_non_differentiable(mean, var, g_count)
        return out.to(input.dtype), mean, var, g_count

    @staticmethod
    def backward(ctx, grad_output, _gmean, _gvar, _gcount):
        xhat, weight, invstd = ctx.saved_tensors
        dims = [0] + list(range(2, grad_output.dim()))
        c = grad_output.size(1)
        shape = [1, c] + [1] * (grad_output.dim() - 2)
        dy = grad_output.float()
        grad_weight = (dy * xhat).sum(dims) if weight is not None else None
        grad_bias = dy.sum(dims)
        glob = _c.allreduce(torch.cat([dy.sum(dims), (dy * xhat).sum(dims)]),
                            op=_c.Sum, name="sync_bn.bwd_stats",
                            process_set=ctx.process_set)
        sum_dy, sum_dy_xhat = glob[:c], glob[c:]
        n = ctx.g_count
        w = weight.float().view(shape) if weight is not None else 1.0
        grad_input = ((dy - (sum_dy / n).view(shape)
                       - xhat * (sum_dy_xhat / n).view(shape))
                      * invstd.view(shape) * w)
        return (grad_input.to(grad_output.dtype),
                grad_weight.to(weight.dtype) if weight is not None else None,
                grad_bias.to(grad_output.dtype) if ctx.has_bias else None,
                None, None)


class SyncBatchNorm(torch.nn.modules.batchnorm._BatchNorm):
    """Drop-in BatchNorm whose training statistics are those of the global
    batch across the world (or ``process_set``); eval mode is plain
    BatchNorm on the running statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True, device=None, dtype=None,
                 process_set=None):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats, device=device, dtype=dtype)
        self.process_set = process_set

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D)")

    def forward(self, input):
        self._check_input_dim(input)
        if not self.training:
            return super().forward(input)
        out, mean, var, g_count = _SyncBatchNormFn.apply(
            input, self.weight, self.bias, self.eps, self.process_set)
        if self.track_running_stats:
            with torch.no_grad():
                unbiased = var * g_count / torch.clamp(g_count - 1, min=1.0)
                if self.num_batches_tracked is not None:
                    self.num_batches_tracked += 1
                m = self.momentum
                if m is None:
                    m = 1.0 / float(self.num_batches_tracked)
                self.running_mean.mul_(1 - m).add_(
                    mean.to(self.running_mean.dtype) * m)
                self.running_var.mul_(1 - m).add_(
                    unbiased.to(self.running_var.dtype) * m)
        return out


def sync_batch_norm_stats(x, process_set=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global batch statistics: (mean, biased var) of ``x`` over all
    processes, reducing every dim but the last. Equal per-process batch
    sizes assumed, as in the reference's allreduce-of-means."""
    xf = torch.as_tensor(x).float()
    axes = tuple(range(xf.dim() - 1))
    local = torch.stack([xf.mean(dim=axes), (xf * xf).mean(dim=axes)])
    glob = _c.allreduce(local, op=_c.Average,
                        name="horovod_tpu.sync_bn.stats",
                        process_set=process_set)
    mean, mean_sq = glob[0], glob[1]
    return mean, torch.clamp(mean_sq - mean * mean, min=0.0)
