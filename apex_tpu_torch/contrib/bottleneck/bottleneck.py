"""Bottleneck block + spatial (H) parallelism with halo exchange
(``apex_tpu/contrib/bottleneck/bottleneck.py``).

- :class:`Bottleneck` — the port's ``models.resnet.Bottleneck`` (the JAX
  module re-exports its model's block the same way).
- :func:`halo_exchange` — ``halo`` rows of H swapped with the ring
  neighbours of a process group, zero rows at the volume's edges: the JAX
  function's two ``ppermute``s as ``torch.distributed`` point-to-point
  sends and receives, differentiable (the backward sends each halo's
  gradient back to the rank that owns those rows).
- :class:`SpatialBottleneck` — the 1x1-3x3-1x1 block on activations whose
  H is split across the group, its 3x3 conv run VALID along H on the
  haloed input, its batch norms :class:`SyncBatchNorm` over the same
  group, so the sharded block computes the unsharded one.

Layout: NCHW (H is dim 2), as the port's ResNet; the JAX module is NHWC.
``group=`` stands for the JAX ``axis_name``; without an initialized
process group (or at world 1) the halo exchange only pads zeros and the
batch norms sync nothing. The convolutions are ``F.conv2d`` calls: the
JAX module leaves them to XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._compat import DeviceLike, as_torch_dtype, resolve_device
from apex_tpu_torch.models.resnet import Bottleneck  # noqa: F401
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm
from apex_tpu_torch.zero.comm import _rank_of, _world_of


def _ring_swap(to_prev, to_next, group):
    """Send ``to_prev`` to rank - 1 and ``to_next`` to rank + 1 of the ring
    of ``group``; returns ``(from_prev, from_next)``."""
    world, rank = _world_of(group), _rank_of(group)

    def peer(r):
        r %= world
        return r if group is None else dist.get_global_rank(group, r)

    from_prev, from_next = torch.empty_like(to_next), torch.empty_like(
        to_prev)
    # tag 0 travels up the ring, tag 1 down: at world 2 both neighbours are
    # one rank, and the tags keep the two messages apart
    ops = [dist.P2POp(dist.isend, to_prev.contiguous(), peer(rank - 1),
                      group, 0),
           dist.P2POp(dist.isend, to_next.contiguous(), peer(rank + 1),
                      group, 1),
           dist.P2POp(dist.irecv, from_prev, peer(rank - 1), group, 1),
           dist.P2POp(dist.irecv, from_next, peer(rank + 1), group, 0)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


class _HaloExchange(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, halo):
        ctx.group, ctx.halo = group, halo
        world, rank = _world_of(group), _rank_of(group)
        zero = torch.zeros_like(x[:, :, :halo])
        if world == 1:
            upper, lower = zero, zero
        else:
            # our top rows go up (they are rank - 1's lower halo), our
            # bottom rows go down
            from_prev, from_next = _ring_swap(x[:, :, :halo],
                                              x[:, :, -halo:], group)
            upper = zero if rank == 0 else from_prev
            lower = zero if rank == world - 1 else from_next
        return torch.cat([upper, x, lower], dim=2)

    @staticmethod
    def backward(ctx, gy):
        group, halo = ctx.group, ctx.halo
        world, rank = _world_of(group), _rank_of(group)
        gx = gy[:, :, halo:-halo].clone()
        if world > 1:
            # the upper halo's gradient belongs to rank - 1's bottom rows,
            # the lower halo's to rank + 1's top rows
            from_prev, from_next = _ring_swap(gy[:, :, :halo],
                                              gy[:, :, -halo:], group)
            if rank > 0:
                gx[:, :, :halo] += from_prev
            if rank < world - 1:
                gx[:, :, -halo:] += from_next
        return gx, None, None


def halo_exchange(x: torch.Tensor, group=None, halo: int = 1):
    """``x`` [N, C, H_local, W] padded to [N, C, H_local + 2 halo, W] with
    the neighbours' rows along H; the first and the last rank of ``group``
    get zero rows at the volume's edges."""
    return _HaloExchange.apply(x, group, halo)


def _conv_weight(out, inp, k, device):
    return nn.Parameter(torch.empty(out, inp, k, k, dtype=torch.float32,
                                    device=device))


class SpatialBottleneck(nn.Module):
    """Bottleneck whose 3x3 conv runs on H-sharded activations: give each
    rank of ``group`` its [N, C, H / world, W] slice. ``dtype`` is the
    convs' compute type (parameters stay fp32 and are cast per call); the
    batch norms compute in fp32 and return their input's dtype. Only
    stride 1 (the reference's spatial path has the same constraint). The
    module lives on ``device``, CUDA by default (it raises without a card
    unless the caller asks for the CPU)."""

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 expansion: int = 4, group=None, dtype: Any = torch.float32,
                 *, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        if strides != 1:
            raise ValueError("SpatialBottleneck supports stride 1 "
                             "(reference parity)")
        out = filters * expansion
        self.group = group
        self.dtype = as_torch_dtype(dtype)
        self.needs_proj = in_features != out
        self.conv1 = _conv_weight(filters, in_features, 1, device)
        self.n1 = SyncBatchNorm(filters, group=group, device=device)
        self.conv2 = _conv_weight(filters, filters, 3, device)
        self.n2 = SyncBatchNorm(filters, group=group, device=device)
        self.conv3 = _conv_weight(out, filters, 1, device)
        self.n3 = SyncBatchNorm(out, group=group, device=device)
        if self.needs_proj:
            self.proj = _conv_weight(out, in_features, 1, device)
            self.n4 = SyncBatchNorm(out, group=group, device=device)

    def _conv(self, x, w, padding=0):
        return F.conv2d(x.to(self.dtype), w.to(self.dtype), None, 1, padding)

    def forward(self, x, train: bool = True):
        ura = not train
        residual = x
        y = self._conv(x, self.conv1)
        y = torch.relu(self.n1(y, use_running_average=ura))
        # 3x3 with halo: pad H with the neighbours' rows, VALID along H
        y = halo_exchange(y, self.group, 1)
        y = self._conv(y, self.conv2, padding=(0, 1))
        y = torch.relu(self.n2(y, use_running_average=ura))
        y = self._conv(y, self.conv3)
        y = self.n3(y, use_running_average=ura)
        if self.needs_proj:
            residual = self._conv(x, self.proj)
            residual = self.n4(residual, use_running_average=ura)
        return torch.relu(y + residual)

    @classmethod
    def params_from_jax(cls, in_features: int, filters: int, *,
                        variables: Mapping, device: DeviceLike = None,
                        **kwargs) -> "SpatialBottleneck":
        """A SpatialBottleneck built with the JAX module's arguments, its
        parameters and running statistics copied from a flax
        ``{"params", "batch_stats"}`` tree of numpy arrays: conv kernels
        HWIO -> OIHW, SyncBatchNorm ``weight``/``bias``/``mean``/``var`` ->
        ``weight``/``bias``/``running_mean``/``running_var``."""
        model = cls(in_features, filters, device=device, **kwargs)
        targets = dict(model.named_parameters())
        targets.update(model.named_buffers())
        seen = set()

        def put(name, arr):
            t = torch.from_numpy(np.array(arr, np.float32))
            if t.dim() == 4:                             # HWIO -> OIHW
                t = t.permute(3, 2, 0, 1)
            dst = targets.get(name)
            if dst is None or tuple(dst.shape) != tuple(t.shape):
                raise ValueError(f"flax leaf for {name!r} {tuple(t.shape)} "
                                 "has no counterpart in the port")
            dst.data = t.contiguous().to(device=dst.device,
                                         dtype=dst.dtype)
            seen.add(name)

        for scope, leaves in variables["params"].items():
            if "kernel" in leaves:
                put(scope, leaves["kernel"])
            else:
                for leaf in ("weight", "bias"):
                    put(f"{scope}.{leaf}", leaves[leaf])
        for scope, leaves in variables.get("batch_stats", {}).items():
            put(f"{scope}.running_mean", leaves["mean"])
            put(f"{scope}.running_var", leaves["var"])
        missing = sorted(set(targets) - seen)
        if missing:
            raise ValueError(f"the flax tree lacks {missing}")
        return model
