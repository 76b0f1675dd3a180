"""ZeRO-3 parameter sharding: the spec, shard/materialize, and the gather
behind the forward whose backward is a reduce-scatter
(``apex_tpu/zero/core.py``).

Each rank keeps 1/world of every (large, floating) parameter resident — a
1-D slice of the zero-padded flattened leaf — and the full parameter
exists only while a forward runs, materialized by :func:`zero_gather`.
Its backward is the conjugate collective: a sharded leaf's cotangent is
zero-padded and reduce-scattered (SUM) in its own dtype, so each rank
receives exactly the summed gradient shard its optimizer partition needs;
a replicated leaf's cotangent is all-reduced whole.

Trees are ordered ``name -> tensor`` dicts in the module's
``named_parameters`` order; the JAX package's ``axis_name`` is a
``group=`` here (:mod:`apex_tpu_torch.zero.comm`). When
``torch.distributed`` is not initialized the world is 1, nothing shards,
and every function is the identity with no collective.

The layout functions take the rank explicitly where it matters —
:func:`shard_tree` (``rank=``) and :func:`assemble_tree` (every rank's
shards, in rank order) — so layouts can be checked in one process; the
group-reading forms (:func:`zero_shard`, :func:`gather_tree`) call them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from apex_tpu_torch.utils.tree import named_tensors
from apex_tpu_torch.zero import comm as _comm
from apex_tpu_torch.zero.rules import DEFAULT_MIN_SHARD_SIZE, match_zero_rules

__all__ = [
    "ZeroSpec", "build_spec", "pad_to_multiple", "shard_tree",
    "assemble_tree", "gather_tree", "zero_shard", "zero_gather",
    "params_resident_bytes", "ZeroShardedModel",
]


@dataclass(frozen=True, eq=False)
class ZeroSpec:
    """Static description of a ZeRO-3 sharding of a parameter tree."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]   # the original (fp32) params' dtypes
    sharded: Tuple[bool, ...]
    world: int
    group: Any = None

    @property
    def sizes(self) -> Tuple[int, ...]:
        out = []
        for s in self.shapes:
            n = 1
            for d in s:
                n *= d
            out.append(n)
        return tuple(out)

    @property
    def padded(self) -> Tuple[int, ...]:
        """Flattened leaf length rounded up to a multiple of world."""
        return tuple(n + (-n) % self.world for n in self.sizes)

    def shard_len(self, i: int) -> int:
        return self.padded[i] // self.world

    @property
    def n_leaves(self) -> int:
        return len(self.shapes)

    def local_offsets(self) -> Tuple[int, ...]:
        """Start of each SHARDED leaf's shard in a per-rank flat buffer
        (tree order, replicated leaves skipped); the same on every rank."""
        offs, acc = [], 0
        for i, sh in enumerate(self.sharded):
            offs.append(acc)
            if sh:
                acc += self.shard_len(i)
        return tuple(offs)


def _named(params) -> Dict[str, torch.Tensor]:
    return {k: p.detach() for k, p in named_tensors(params).items()}


def build_spec(params, rules: Optional[Sequence[Tuple[str, str]]] = None, *,
               group=None, world: Optional[int] = None,
               min_shard_size: int = DEFAULT_MIN_SHARD_SIZE) -> ZeroSpec:
    """The sharding spec of ``params`` under the rule table. ``world``
    defaults to the group's size (1 when ``torch.distributed`` is not
    initialized, where nothing shards)."""
    world = _comm._world_of(group) if world is None else int(world)
    tree = _named(params)
    decisions = match_zero_rules(rules, tree, min_shard_size=min_shard_size)
    return ZeroSpec(
        names=tuple(tree),
        shapes=tuple(tuple(x.shape) for x in tree.values()),
        dtypes=tuple(x.dtype for x in tree.values()),
        sharded=tuple(decisions[k] and world > 1 for k in tree),
        world=world, group=group)


def _pad_flat(flat: torch.Tensor, padded: int) -> torch.Tensor:
    if flat.shape[0] != padded:
        flat = torch.cat([flat, flat.new_zeros(padded - flat.shape[0])])
    return flat


def pad_to_multiple(flat: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad a 1-D buffer to a multiple of ``mult``: every rank's slice
    of a flat buffer has the same length."""
    return _pad_flat(flat, flat.shape[0] + (-flat.shape[0]) % mult)


def _check_leaves(tree: Mapping, spec: ZeroSpec, what: str) -> None:
    if len(tree) != spec.n_leaves:
        raise ValueError(f"{what}: tree has {len(tree)} leaves, spec "
                         f"describes {spec.n_leaves}")


def shard_tree(tree, spec: ZeroSpec, rank: Optional[int] = None
               ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s resident tree (default: this process's rank in the
    spec's group): sharded leaves become a fresh 1-D slice ``[padded /
    world]`` of the zero-padded flat leaf, dtype kept; replicated leaves
    pass through. World 1 is the identity."""
    tree = dict(tree)
    _check_leaves(tree, spec, "shard_tree")
    if spec.world == 1:
        return tree
    rank = _comm._rank_of(spec.group) if rank is None else rank
    out = {}
    for i, (k, x) in enumerate(tree.items()):
        if not spec.sharded[i]:
            out[k] = x
            continue
        per = spec.shard_len(i)
        flat = _pad_flat(x.reshape(-1), spec.padded[i])
        out[k] = flat[rank * per:(rank + 1) * per].clone()
    return out


def _unpad(full: torch.Tensor, spec: ZeroSpec, i: int) -> torch.Tensor:
    return full[:spec.sizes[i]].view(spec.shapes[i])


def assemble_tree(rank_trees: Sequence[Mapping], spec: ZeroSpec
                  ) -> Dict[str, torch.Tensor]:
    """The full tree from every rank's resident tree, in rank order — the
    single-process form of :func:`gather_tree`."""
    if len(rank_trees) != spec.world:
        raise ValueError(f"assemble_tree: {len(rank_trees)} rank trees for "
                         f"world {spec.world}")
    trees = [dict(t) for t in rank_trees]
    out = {}
    for i, k in enumerate(spec.names):
        if not spec.sharded[i]:
            out[k] = trees[0][k]
            continue
        out[k] = _unpad(torch.cat([t[k] for t in trees]), spec, i)
    return out


def gather_tree(shards, spec: ZeroSpec, overlap_comm: bool = False
                ) -> Dict[str, torch.Tensor]:
    """The full tree from this rank's shards: per sharded leaf an
    all-gather, unpad and reshape; replicated leaves pass through."""
    shards = dict(shards)
    _check_leaves(shards, spec, "gather_tree")
    out = {}
    for i, (k, x) in enumerate(shards.items()):
        if not spec.sharded[i]:
            out[k] = x
            continue
        full = _comm.all_gather_flat(x, spec.group, overlap_comm=overlap_comm)
        out[k] = _unpad(full, spec, i)
    return out


def params_resident_bytes(spec: ZeroSpec, dtypes=None) -> int:
    """Per-rank resident parameter bytes under ``spec``; ``dtypes``
    overrides the spec's (O2: bf16 resident shards)."""
    dts = spec.dtypes if dtypes is None else tuple(dtypes)
    total = 0
    for i, sh in enumerate(spec.sharded):
        n = spec.shard_len(i) if sh else spec.sizes[i]
        total += n * torch.empty((), dtype=dts[i]).element_size()
    return total


def zero_shard(params, spec: ZeroSpec) -> Dict[str, torch.Tensor]:
    """This rank's resident tree (see :func:`shard_tree`). The JAX
    package's resident-bytes gauge waits for the monitor port (A14);
    :func:`params_resident_bytes` gives the number."""
    return shard_tree(_named(params), spec)


class _ZeroGather(torch.autograd.Function):
    """Forward: the gather. Backward: reduce-scatter of each sharded
    leaf's zero-padded cotangent, in its own dtype; all-reduce of each
    replicated leaf's."""

    @staticmethod
    def forward(ctx, spec, overlap_comm, *shards):
        ctx.spec = spec
        ctx.overlap_comm = overlap_comm
        full = gather_tree(dict(zip(spec.names, shards)), spec, overlap_comm)
        return tuple(full.values())

    @staticmethod
    def backward(ctx, *cts):
        spec = ctx.spec
        out = []
        for i, g in enumerate(cts):
            if g is None or not g.is_floating_point():
                out.append(g)
            elif not spec.sharded[i]:
                out.append(_comm.psum_flat(g, spec.group))
            else:
                flat = _pad_flat(g.reshape(-1), spec.padded[i])
                out.append(_comm.reduce_scatter_flat(
                    flat, spec.group, overlap_comm=ctx.overlap_comm))
        return (None, None, *out)


def zero_gather(shards, spec: ZeroSpec, overlap_comm: bool = False
                ) -> Dict[str, torch.Tensor]:
    """Materialize the full tree from this rank's shards, differentiably:
    gradients flow back to the shards reduce-scattered (sharded leaves)
    or all-reduced (replicated leaves)."""
    shards = dict(shards)
    _check_leaves(shards, spec, "zero_gather")
    full = _ZeroGather.apply(spec, overlap_comm, *shards.values())
    return dict(zip(spec.names, full))


class _BoundCall(nn.Module):
    """``fn(module, *args)`` as a module, so ``functional_call`` can run
    it with the module's parameters replaced."""

    def __init__(self, module: nn.Module, fn: Callable):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(self.module, *args, **kwargs)


class ZeroShardedModel:
    """FSDP semantics around an ``nn.Module``.

    ``zm = ZeroShardedModel(module, rules=..., group=...)``, then::

        shards = zm.shard()            # fp32 resident tree; builds zm.spec
        out    = zm(shards, *args)     # gather -> module(*args) on it

    ``amp.initialize(..., zero=...)`` builds this wrapper around the module
    and attaches the amp model, so ``cast_params`` applies the opt level's
    cast to the resident tree and ``__call__`` casts inputs and outputs.
    Resident tensors are updated in place by the ZeRO step; a replicated
    leaf the cast leaves alone shares storage with the module's parameter.
    """

    def __init__(self, module: Optional[nn.Module],
                 rules: Optional[Sequence[Tuple[str, str]]] = None, *,
                 group=None, min_shard_size: int = DEFAULT_MIN_SHARD_SIZE,
                 overlap_comm: bool = False):
        _comm._no_overlap(overlap_comm)
        self.module = module
        self.rules = rules
        self.group = group
        self.min_shard_size = min_shard_size
        self.overlap_comm = overlap_comm
        self.spec: Optional[ZeroSpec] = None
        self._amp_model = None

    def shard(self, params=None) -> Dict[str, torch.Tensor]:
        """Build (and keep) the spec; return this rank's resident tree.
        ``params``: the ORIGINAL (fp32) tree, default the module's
        parameters — the optimizer's masters come from full precision;
        cast the result afterwards (:meth:`cast_params`)."""
        params = _named(self.module if params is None else params)
        self.spec = build_spec(params, self.rules, group=self.group,
                               min_shard_size=self.min_shard_size)
        return zero_shard(params, self.spec)

    def materialize(self, shards) -> Dict[str, torch.Tensor]:
        """The differentiable gather (:func:`zero_gather`)."""
        if self.spec is None:
            raise ValueError("ZeroShardedModel: call shard(params) first "
                             "(the spec is built there)")
        return zero_gather(shards, self.spec, self.overlap_comm)

    def cast_params(self, shards) -> Dict[str, torch.Tensor]:
        """The opt level's cast of the resident tree (the amp model's
        rule; the identity without amp). Names are unchanged by sharding,
        so the keep-fp32 rules apply as they are."""
        if self._amp_model is None:
            return dict(shards)
        return self._amp_model.cast_tree(shards)

    def call(self, full, fn: Callable, *args, **kwargs):
        """``fn(module, *args, **kwargs)`` with the module's parameters
        replaced by ``full`` for the call (``torch.func.functional_call``
        over a wrapper module whose forward is ``fn``)."""
        return torch.func.functional_call(
            _BoundCall(self.module, fn),
            {f"module.{k}": v for k, v in full.items()}, args, kwargs)

    def __call__(self, shards, *args, **kwargs):
        full = self.materialize(shards)
        if self._amp_model is not None:
            return self._amp_model.call_with(full, *args, **kwargs)
        return self.call(full, lambda m, *a, **k: m(*a, **k), *args,
                         **kwargs)
