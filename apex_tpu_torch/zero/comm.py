"""ZeRO collectives over ``torch.distributed`` (``apex_tpu/zero/comm.py``).

Every sharded-optimizer data movement of the port goes through these
functions:

- :func:`all_gather_flat` — ``all_gather_into_tensor``: ``[per] ->
  [world * per]``, rank ``i``'s block at ``i * per``;
- :func:`reduce_scatter_flat` — ``reduce_scatter_tensor`` with SUM:
  ``[world * per] -> [per]``, rank ``i`` receiving the cross-rank sum of
  block ``i``, in the buffer's own dtype;
- :func:`psum_flat` — ``all_reduce`` with SUM;
- :func:`quantized_all_gather` — apex's e5m2 compressed parameter
  broadcast (``apex/contrib/optimizers/distributed_fused_adam.py:477``),
  raw or through the amp fp8 codec (``scaled=True``).

Where the JAX package names a mesh axis (``axis_name``), the port takes a
``group=`` (a ``ProcessGroup``; ``None`` is the default WORLD group). The
JAX "unbound axis" rule carries over: when ``torch.distributed`` is not
initialized the world is 1, and at world 1 every function is the
identity and runs no collective.

fp8 travels as bits: the wire buffer is viewed as ``uint8`` for the
collective on every backend (gloo refuses ``float8_e5m2`` tensors), and
viewed back after it, so no value is ever upcast on the wire.

``overlap_comm=True`` (the ppermute rings of ``parallel/overlap.py``)
raises ``NotImplementedError`` until the data-parallel slice (ROADMAP A9).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.amp import fp8 as _fp8


def _world_of(group=None) -> int:
    """World size of ``group``, or 1 when ``torch.distributed`` is not
    initialized (the optimizers' world-1 degradation)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _rank_of(group=None) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def same_group(a, b) -> bool:
    """Do two ``group=`` arguments name the same process group (``None``
    is WORLD)?"""
    if dist.is_available() and dist.is_initialized():
        world = dist.group.WORLD
        a = world if a is None else a
        b = world if b is None else b
    return a is b


def _no_overlap(overlap_comm: bool) -> None:
    if overlap_comm:
        raise NotImplementedError(
            "overlap_comm=True (the ring-decomposed collectives of "
            "parallel/overlap.py) is not ported yet (ROADMAP A9)")


def all_gather_flat(shard: torch.Tensor, group=None, *,
                    overlap_comm: bool = False) -> torch.Tensor:
    """Full flat buffer from this rank's shard. Identity at world 1."""
    _no_overlap(overlap_comm)
    world = _world_of(group)
    if world == 1:
        return shard
    out = torch.empty((world * shard.numel(),), dtype=shard.dtype,
                      device=shard.device)
    dist.all_gather_into_tensor(out, shard.contiguous(), group=group)
    return out


def reduce_scatter_flat(flat: torch.Tensor, group=None, *,
                        overlap_comm: bool = False) -> torch.Tensor:
    """Summed local shard of a full flat buffer. Identity at world 1."""
    _no_overlap(overlap_comm)
    world = _world_of(group)
    if world == 1:
        return flat
    if flat.numel() % world:
        raise ValueError(f"reduce_scatter_flat: {flat.numel()} elements do "
                         f"not split over {world} ranks (pad first)")
    out = torch.empty((flat.numel() // world,), dtype=flat.dtype,
                      device=flat.device)
    dist.reduce_scatter_tensor(out, flat.contiguous(), op=dist.ReduceOp.SUM,
                               group=group)
    return out


def psum_flat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Cross-rank sum (a new tensor). Identity at world 1."""
    if _world_of(group) == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _gather_bits(wire: torch.Tensor, group) -> torch.Tensor:
    """All-gather an fp8 buffer as its bytes."""
    full = all_gather_flat(wire.view(torch.uint8), group)
    return full.view(wire.dtype)


def quantized_all_gather(shard: torch.Tensor, group=None, *,
                         wire_dtype: torch.dtype = _fp8.E5M2,
                         out_dtype=None, overlap_comm: bool = False,
                         scaled: bool = False) -> torch.Tensor:
    """All-gather ``shard`` through a narrow wire dtype; every block, the
    local one included, has round-tripped through ``wire_dtype``.

    ``scaled=False``: the reference's raw cast. ``scaled=True``: the amp
    fp8 codec — the cross-rank amax (``all_reduce(MAX)``) sets one scale
    that brings the tensor inside the format before the cast, and the
    gathered buffer is divided by it straight after the gather."""
    _no_overlap(overlap_comm)
    out_dtype = shard.dtype if out_dtype is None else out_dtype
    if not scaled:
        return _gather_bits(shard.to(wire_dtype), group).to(out_dtype)
    amax = _fp8.amax(shard)
    if _world_of(group) > 1:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = _fp8.compute_scale(amax, _fp8.fp8_max(wire_dtype))
    wire = _fp8.quantize(shard, scale, wire_dtype)
    return _fp8.dequantize(_gather_bits(wire, group), scale, out_dtype)
