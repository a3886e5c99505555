"""BatchNorm whose train-mode statistics span every rank of a mesh.

The JAX package's data-parallel ``Trainer(mesh=)`` is one program over
the global batch, so its ``BatchNorm3d`` takes the mean and variance over
every example on every device. :class:`SyncBatchNorm3d` does the same
over ``torch.distributed``: per channel, each rank's count, sum and sum
of squares (from its local mean and variance, in float64) go through
one ``all_reduce`` over the mesh; the global mean and biased variance
normalize, and the running statistics take the unbiased variance with
momentum 0.1, as ``nn.BatchNorm3d`` does. The backward reduces the
per-channel sums of ``dy`` and ``dy * x_hat`` (accumulated in float64)
the same way; the weight and bias gradients stay this rank's share,
which the Trainer's gradient ``all_reduce`` sums. Statistics and
gradients are computed in float32 (float64 for float64 input) whatever
the input's dtype, as PyTorch's own BatchNorm does under autocast; the
output has the input's dtype. In eval mode it is ``nn.BatchNorm3d``.
"""

import torch
from torch import nn

from aind_exaspim_neuron_segmentation_tpu_torch.parallel.mesh import (
    all_reduce_sum,
)

_DIMS = (0, 2, 3, 4)


def _view(v):
    return v.view(1, -1, 1, 1, 1)


class _SyncBatchNorm(torch.autograd.Function):
    """The train-mode forward and backward over the mesh ``spec``."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum, spec):
        op = torch.float64 if x.dtype == torch.float64 else torch.float32
        with torch.autocast(x.device.type, enabled=False):
            xc = x.to(op)
            n = xc.numel() // xc.shape[1]
            var, mean = torch.var_mean(xc, dim=_DIMS, unbiased=False)
            mean, var = mean.double(), var.double()
            moments = torch.stack([
                torch.full_like(mean, n), n * mean, n * (var + mean * mean)])
            count, s1, s2 = all_reduce_sum(moments, spec)
            total = count[0]
            g_mean = s1 / total
            g_var = torch.clamp(s2 / total - g_mean * g_mean, min=0.0)
            with torch.no_grad():
                unbiased = g_var * (total / torch.clamp(total - 1, min=1))
                running_mean.mul_(1 - momentum).add_(
                    momentum * g_mean.to(running_mean.dtype))
                running_var.mul_(1 - momentum).add_(
                    momentum * unbiased.to(running_var.dtype))
            invstd = torch.rsqrt(g_var + eps).to(op)
            mean = g_mean.to(op)
            scale = invstd * weight.to(op)
            y = (xc - _view(mean)) * _view(scale) + _view(bias.to(op))
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.total, ctx.spec = total, spec
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        op = invstd.dtype
        with torch.autocast(dy.device.type, enabled=False):
            dy = dy.to(op)
            xhat = (x.to(op) - _view(mean)) * _view(invstd)
            # float64 sums: sum(dy) of a channel can be far smaller than
            # its terms (a float32 sum of millions of them cancels)
            f64 = torch.float64
            local = torch.stack([dy.sum(_DIMS, dtype=f64),
                                 (dy * xhat).sum(_DIMS, dtype=f64)])
            # a copy: the all_reduce may sum in place, and ``local`` is
            # this rank's share of the weight and bias gradients
            total = all_reduce_sum(local.clone(), ctx.spec).to(op)
            mean_dy = _view(total[0] / ctx.total.to(op))
            mean_dy_xhat = _view(total[1] / ctx.total.to(op))
            dx = (dy - mean_dy - xhat * mean_dy_xhat) * _view(
                invstd * weight.to(op))
        return (dx.to(x.dtype), local[1].to(weight.dtype),
                local[0].to(weight.dtype), None, None, None, None, None)


class SyncBatchNorm3d(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` whose train-mode statistics span the ranks of
    ``mesh`` (a ``RankMesh``, a process group, or None for the whole
    job). Same parameters, buffers and ``state_dict`` keys; momentum
    must be a number, as in every BatchNorm of the port's UNet3D."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, mesh=None):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.mesh = mesh

    def forward(self, x):
        """Normalize ``x`` (N, C, D, H, W) by the mesh-wide statistics in
        train mode, by the running statistics in eval mode."""
        if not self.training:
            return super().forward(x)
        if x.dim() != 5:
            raise ValueError(f"expected a 5-D input, got {x.dim()}-D")
        self.num_batches_tracked.add_(1)
        return _SyncBatchNorm.apply(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            self.eps, self.momentum, self.mesh)


def convert_sync_batchnorm(module, mesh):
    """Replace every ``nn.BatchNorm3d`` inside ``module`` with a
    :class:`SyncBatchNorm3d` over ``mesh`` that holds the same parameter
    and buffer tensors (so optimizers and ``state_dict`` keys are
    unchanged). Returns ``module``."""
    for name, child in module.named_children():
        if type(child) is nn.BatchNorm3d:
            sync = SyncBatchNorm3d(child.num_features, child.eps,
                                   child.momentum, mesh)
            sync.weight, sync.bias = child.weight, child.bias
            for key in ("running_mean", "running_var",
                        "num_batches_tracked"):
                setattr(sync, key, getattr(child, key))
            sync.train(child.training)
            setattr(module, name, sync)
        else:
            convert_sync_batchnorm(child, mesh)
    return module
