"""Synchronized BatchNorm over ``torch.distributed``
(``apex_tpu/parallel/sync_batchnorm.py``).

The batch statistics are merged across the ranks of a process group: each
rank sums its fp32 ``[sum, sumsq, count]`` and one ``all_reduce`` (SUM)
adds them, so ranks may hold different batch sizes (a count-weighted
merge, the reference's parallel Welford combine). The all-reduce is
differentiable — its backward all-reduces the incoming gradient — which
gives the reference's all-reduced ``sum_dy`` / ``sum_dy_xmu`` terms of the
backward. ``group=`` stands where the JAX module names ``axis_name`` and
``axis_index_groups``: ``None`` is the default (WORLD) group, a sub-group
from :func:`create_syncbn_process_group` syncs within it, and without an
initialized process group (or at world 1) the module is ordinary batch
norm and runs no collective.

Conventions, as the JAX module: ``momentum`` is torch's (``new = (1 - m)
* old + m * batch``), the running variance is the unbiased one
(``var * count / max(count - 1, 1)``), the normalization uses the biased
batch variance, the math is fp32 and the output has the input's dtype.
``z`` is a residual added before the optional ``fuse_relu`` (the group-BN
``bn_add_relu`` fusion). The feature axis is 1 (NCHW, PyTorch's layout);
``channel_last=True`` takes it from the last axis (the JAX layout).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch._compat import resolve_device
from apex_tpu_torch.zero.comm import _world_of


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce(SUM)`` over ``group`` whose backward all-reduces the
    gradient (every rank's output depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def create_syncbn_process_group(group_size: int,
                                world_size: Optional[int] = None):
    """Partition the world into contiguous groups of ``group_size`` ranks
    (``apex/parallel/__init__.py:58-97``) and return this rank's group.
    Every rank must call it (``new_group`` is collective). ``group_size``
    0 or equal to the world returns None, the whole world, as the JAX
    package returns no index groups."""
    if world_size is None:
        world_size = _world_of(None)
    if group_size == 0 or group_size == world_size:
        return None
    if world_size % group_size != 0:
        raise ValueError("world_size must be divisible by group_size")
    rank = dist.get_rank()
    mine = None
    for start in range(0, world_size, group_size):
        g = dist.new_group(ranks=list(range(start, start + group_size)))
        if start <= rank < start + group_size:
            mine = g
    return mine


class SyncBatchNorm(nn.Module):
    """Drop-in BatchNorm whose batch statistics are reduced over ``group``
    (module docstring). ``forward(x, z=None, use_running_average=None)``:
    ``use_running_average`` defaults to ``not self.training``. Parameters
    and statistics live on ``device``: CUDA by default, which raises
    without a card unless the caller asks for the CPU."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True, group=None,
                 fuse_relu: bool = False, channel_last: bool = False, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.group = group
        self.fuse_relu = fuse_relu
        self.channel_last = channel_last
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features, dtype=dtype,
                                                  device=device))
            self.bias = nn.Parameter(torch.zeros(num_features, dtype=dtype,
                                                 device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        f32 = dict(dtype=torch.float32, device=device)
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))

    def _feature_axis(self, x):
        return x.dim() - 1 if self.channel_last else 1

    def forward(self, x, z=None, use_running_average: Optional[bool] = None):
        c = self.num_features
        ax = self._feature_axis(x)
        if x.shape[ax] != c:
            raise ValueError(f"expected feature axis {ax} of size {c}, got "
                             f"{tuple(x.shape)}")
        if use_running_average is None:
            use_running_average = not self.training
        shape = [1] * x.dim()
        shape[ax] = c
        x32 = x.float()
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            red = [d for d in range(x.dim()) if d != ax]
            count = torch.tensor([float(x.numel() // c)], device=x.device)
            stats = torch.cat([x32.sum(dim=red), (x32 * x32).sum(dim=red),
                               count])
            if _world_of(self.group) > 1:
                stats = _AllReduceSum.apply(stats, self.group)
            g_sum, g_sumsq, g_count = stats[:c], stats[c:2 * c], stats[2 * c]
            mean = g_sum / g_count
            var = g_sumsq / g_count - mean * mean   # biased, as BN trains
            if self.track_running_stats:
                with torch.no_grad():
                    unbiased = var * g_count / torch.clamp(g_count - 1.0,
                                                           min=1.0)
                    m = self.momentum
                    self.running_mean.copy_((1 - m) * self.running_mean
                                            + m * mean)
                    self.running_var.copy_((1 - m) * self.running_var
                                           + m * unbiased)
        y = (x32 - mean.reshape(shape)) * torch.rsqrt(var + self.eps).reshape(
            shape)
        if self.affine:
            y = y * self.weight.float().reshape(shape) + \
                self.bias.float().reshape(shape)
        if z is not None:
            y = y + z.float()
        if self.fuse_relu:
            y = torch.relu(y)
        return y.to(x.dtype)

    def extra_repr(self) -> str:
        return (f"{self.num_features}, eps={self.eps}, "
                f"momentum={self.momentum}, fuse_relu={self.fuse_relu}, "
                f"channel_last={self.channel_last}")


def convert_syncbn_model(module: nn.Module, process_group=None,
                         channel_last: bool = False) -> nn.Module:
    """Swap every ``torch.nn`` BatchNorm child of ``module`` (recursively)
    for a :class:`SyncBatchNorm` over ``process_group`` with the same
    features, eps, momentum, affine flag, parameters and running
    statistics (``apex/parallel/__init__.py:21-56``). Returns the module,
    or the replacement when ``module`` itself is a BatchNorm."""
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        dev = (module.weight.device if module.weight is not None
               else module.running_mean.device
               if module.running_mean is not None else None)
        new = SyncBatchNorm(module.num_features, module.eps,
                            0.1 if module.momentum is None
                            else module.momentum,
                            module.affine, module.track_running_stats,
                            process_group, channel_last=channel_last,
                            device=dev)
        with torch.no_grad():
            if module.affine:
                new.weight.copy_(module.weight)
                new.bias.copy_(module.bias)
            if module.track_running_stats:
                new.running_mean.copy_(module.running_mean)
                new.running_var.copy_(module.running_var)
        new.train(module.training)
        return new
    for name, child in module.named_children():
        new_child = convert_syncbn_model(child, process_group, channel_last)
        if new_child is not child:
            setattr(module, name, new_child)
    return module
