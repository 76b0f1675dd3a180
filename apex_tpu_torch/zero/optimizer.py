"""ZeroOptimizer: every ZeRO tier behind one class
(``apex_tpu/zero/optimizer.py``).

===========================  ==========================================
``shard_params=False``       ZeRO-1/2 — the optimizer state (fp32 master,
(tier 1/2; the                m, v) is ONE flat ``[total/world]`` shard per
``DistributedFusedAdam`` /    rank; parameters and gradients are full: the
``DistributedFusedLAMB``      flat gradient is reduce-scattered, the shard
configuration)                updated, the fresh parameters all-gathered
                              (optionally through the e5m2 wire) and
                              written into the parameters in place.
``shard_params=True``        ZeRO-3 — the parameters are sharded too
(tier 3)                      (``zero/core.py``): the backward hands this
                              optimizer its summed gradient shards, the
                              update runs on the local partition, and no
                              gather happens here.
===========================  ==========================================

Both tiers run the update of every floating leaf as ONE launch of the B13
kernel (``zero/fused_update.py``) over one flat fp32 buffer, as the JAX
package's fused path concatenates the leaves. Tier 3 keeps master, m and v
as one flat fp32 buffer each, and the state's per-leaf trees are views into
it, so each step concatenates nothing but the gradient.

The update is IN PLACE: the state's buffers and the parameters (tier 1/2)
or resident shards (tier 3) are written, and the returned state holds the
same tensors with a new ``step``. A set ``skip`` (amp's ``found_inf``)
leaves every buffer and the step bitwise unchanged — the JAX ``lax.cond``
— decided on the device (the kernel writes nothing), with no host read.

LAMB follows the JAX layouts exactly: tier 1/2 takes per-leaf sums over
the leaf ∩ shard ranges (:meth:`ZeroOptimizer._range_sums`; the rank is
known on the host here, so the ranges are plain slices) and builds the
per-position trust ratio as the JAX delta scatter + cumsum
(:meth:`ZeroOptimizer._piecewise`); tier 3 merges per-leaf partial sums
with one masked all-reduce (:meth:`ZeroOptimizer._masked_psum_merge`).
Both clip by the global gradient norm first.

Not ported yet: ``overlap_comm=True`` (ROADMAP A9) and ``autotune``
(A14) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from apex_tpu_torch.utils.flat import FlatBuffer
from apex_tpu_torch.utils.tree import named_tensors
from apex_tpu_torch.zero import comm as _comm
from apex_tpu_torch.zero.core import ZeroSpec, pad_to_multiple
from apex_tpu_torch.zero.fused_update import fused_shard_update
from apex_tpu_torch.zero.update import (ShardedAdamState, ShardedLambState,
                                        Zero3State, lamb_trust_ratio)

__all__ = ["ZeroOptimizer", "ShardedAdamState", "ShardedLambState",
           "Zero3State"]


class _FlatTree(dict):
    """``name -> tensor`` whose floating leaves are views into ``flat``
    (in ``float_names`` order): the tier-3 master/m/v layout."""

    flat: torch.Tensor
    float_names: tuple


def _flat_tree(flat: torch.Tensor, like: Dict[str, torch.Tensor],
               floats: List[str], other) -> _FlatTree:
    out, off = _FlatTree(), 0
    for k, x in like.items():
        if k in floats:
            n = x.numel()
            out[k] = flat[off:off + n].view(x.shape)
            off += n
        else:
            out[k] = other(k, x)
    out.flat = flat
    out.float_names = tuple(floats)
    return out


class ZeroOptimizer:
    """Sharded fused Adam(W)/LAMB over the ranks of ``group``.

    ``kind`` selects the update ("adam" or "lamb"), ``shard_params`` the
    tier (module table). Tier 3 needs the
    :class:`~apex_tpu_torch.zero.core.ZeroSpec` of the resident tree:
    pass it to ``init``/``apply`` or construct with ``spec=``. At world 1
    (``torch.distributed`` not initialized, or a group of one) nothing
    shards and no collective runs: a fused update over every parameter.
    """

    def __init__(self, lr=1e-3, *, kind: str = "adam",
                 shard_params: bool = True, bias_correction: bool = True,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True,
                 gradient_average: bool = True,
                 max_grad_norm: Optional[float] = None,
                 use_nvlamb: bool = False, group=None,
                 overlap_comm: bool = False, compress_allgather=False,
                 spec: Optional[ZeroSpec] = None, autotune=None):
        if kind not in ("adam", "lamb"):
            raise ValueError(f"kind must be 'adam' or 'lamb', got {kind!r}")
        if compress_allgather not in (False, True, "scaled"):
            raise ValueError(
                f"compress_allgather must be False, True or 'scaled', "
                f"got {compress_allgather!r}")
        _comm._no_overlap(overlap_comm)
        if autotune is not None:
            raise NotImplementedError(
                "ZeroOptimizer(autotune=...): the tuner is not ported yet "
                "(ROADMAP A14); the fused update always runs")
        self.kind = kind
        self.shard_params = shard_params
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.gradient_average = gradient_average
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.group = group
        self.overlap_comm = overlap_comm
        self.compress_allgather = compress_allgather
        self.autotune = autotune
        self._zspec = spec
        self._spec: Optional[FlatBuffer] = None   # tier-1/2 flat layout
        self._scaler = None
        self._cache: dict = {}                    # device index tensors
        self.param_groups: List[dict] = []

    # -- shared plumbing ----------------------------------------------------
    def _world(self) -> int:
        return _comm._world_of(self.group)

    def _rank(self) -> int:
        return _comm._rank_of(self.group)

    def _hyper(self):
        return dict(betas=self.betas, eps=self.eps,
                    weight_decay=self.weight_decay,
                    adam_w_mode=self.adam_w_mode,
                    bias_correction=self.bias_correction,
                    grad_averaging=self.gradient_average)

    def _lr(self, lr):
        return self.lr if lr is None else lr

    def _device_tensor(self, key, make):
        """A small index/mask tensor made once (its copy to the device is
        the only host transfer, at the first step)."""
        t = self._cache.get(key)
        if t is None:
            t = self._cache[key] = make()
        return t

    def configure_amp(self, properties, scaler):
        """``amp.initialize`` hook: the fp32 master shard is the O2 master
        store already; keep the scaler for the train steps."""
        self._scaler = scaler

    def _clip(self, g, gsq_total):
        if self.max_grad_norm and self.max_grad_norm > 0:
            gnorm = torch.sqrt(gsq_total)
            return g / torch.clamp(gnorm / self.max_grad_norm, min=1.0)
        return g

    # -- dispatch -----------------------------------------------------------
    def init(self, params, spec: Optional[ZeroSpec] = None):
        """Tier 1/2: ``params`` is the full model (a module, a ``name ->
        tensor`` dict or a list). Tier 3: the RESIDENT tree of
        ``zero_shard`` (fp32: master precision is set here) and its spec."""
        if self.shard_params:
            return self._init3(params, spec)
        return self._init_flat(params)

    def apply(self, state, params, grads, skip=None, lr=None,
              spec: Optional[ZeroSpec] = None):
        """One sharded step; returns ``(params, new_state)``.

        Tier 1/2: full ``params``/``grads`` (same structure), the fresh
        parameters written into ``params``. Tier 3: resident shards and
        gradient shards (a ``name -> tensor`` dict, or one flat fp32
        buffer over the floating leaves in tree order), the fresh values
        written into the resident shards."""
        if self.shard_params:
            return self._apply3(state, params, grads, skip=skip, lr=lr,
                                spec=spec)
        plist = list(named_tensors(params).values())
        if self._spec is None:
            self._spec = FlatBuffer.from_tree(named_tensors(params))
        glist = list(named_tensors(grads).values())
        flat_g = torch.cat([g.reshape(-1).float() for g in glist])
        return plist, self._step_flat(state, plist, flat_g, skip, lr)

    def apply_flat(self, state, flat_grads: torch.Tensor, skip=None, lr=None):
        """Tier 1/2 with the gradients of ``init``'s parameters as one flat
        fp32 buffer (what ``amp.scaler.unscale`` returns): the form
        ``amp.make_train_step`` calls. Returns the new state."""
        if self.shard_params:
            raise ValueError("apply_flat is the tier-1/2 entry; tier 3 "
                             "steps through zero.make_train_step")
        return self._step_flat(state, self.param_groups[0]["params"],
                               flat_grads, skip, lr)

    # ======================================================================
    # tier 1/2: flat [total/world] shard, full params at the boundary
    # ======================================================================
    def _init_flat(self, params):
        tree = named_tensors(params)
        self.param_groups = [{"params": list(tree.values())}]
        self._spec = FlatBuffer.from_tree(tree)
        world = self._world()
        flat = pad_to_multiple(
            self._spec.pack({k: p.detach() for k, p in tree.items()},
                            dtype=torch.float32), world)
        per = flat.numel() // world
        if world > 1:
            rank = self._rank()
            flat = flat[rank * per:(rank + 1) * per].clone()
        cls = ShardedAdamState if self.kind == "adam" else ShardedLambState
        return cls(step=torch.zeros((), dtype=torch.int32,
                                    device=flat.device),
                   master_shard=flat, m_shard=torch.zeros_like(flat),
                   v_shard=torch.zeros_like(flat))

    def _leaf_ranges(self, base: int, per: int):
        """Each leaf's range in shard coordinates, clipped to the shard."""
        out = []
        for off, size in zip(self._spec.offsets, self._spec.sizes):
            out.append((min(max(off - base, 0), per),
                        min(max(off + size - base, 0), per)))
        return out

    def _range_sums(self, x, base: int, per: int):
        """Per-leaf sums of ``x`` over the leaf ∩ shard ranges (0 for a
        leaf outside this shard)."""
        return torch.stack([x[s:e].sum()
                            for s, e in self._leaf_ranges(base, per)])

    def _piecewise(self, values, base: int, per: int):
        """``[per]`` vector equal to ``values[i]`` on leaf i's shard range:
        the JAX delta scatter + cumsum (positions past the last leaf, the
        alignment padding, carry the last value: harmless, padding is 0
        in p and in the update)."""
        starts = self._device_tensor(
            ("starts", base, per, values.device),
            lambda: torch.tensor([s for s, _ in self._leaf_ranges(base, per)],
                                 dtype=torch.int64, device=values.device))
        zero = torch.zeros((1,), dtype=values.dtype, device=values.device)
        deltas = torch.diff(values, prepend=zero)
        d = torch.zeros((per + 1,), dtype=values.dtype, device=values.device)
        d.index_add_(0, starts, deltas)
        return torch.cumsum(d[:per], 0)

    def _step_flat(self, state, plist, flat_g, skip, lr):
        spec = self._spec
        if flat_g.dtype != torch.float32 or flat_g.numel() != spec.total:
            raise ValueError(f"flat gradients: expected {spec.total} fp32 "
                             f"values, got {flat_g.numel()} {flat_g.dtype}")
        world = self._world()
        lr = self._lr(lr)
        with torch.no_grad():
            flat_g = pad_to_multiple(flat_g, world)
            per = flat_g.numel() // world
            g = _comm.reduce_scatter_flat(flat_g, self.group)
            if self.gradient_average and world > 1:
                g = g / world
            base = self._rank() * per if world > 1 else 0
            if self.kind == "lamb":
                g = self._clip(g, _comm.psum_flat(torch.sum(g * g),
                                                  self.group))
            p = state.master_shard
            step = state.step + 1
            out, _, _ = fused_shard_update(
                p, g, state.m_shard, state.v_shard, step, kind=self.kind,
                lr=lr, skip=skip, **self._hyper())
            if self.kind == "lamb":
                w_sq = _comm.psum_flat(self._range_sums(p * p, base, per),
                                       self.group)
                u_sq = _comm.psum_flat(self._range_sums(out * out, base, per),
                                       self.group)
                ratio = lamb_trust_ratio(torch.sqrt(w_sq), torch.sqrt(u_sq),
                                         use_nvlamb=self.use_nvlamb,
                                         weight_decay=self.weight_decay)
                new_p = p - lr * self._piecewise(ratio, base, per) * out
                p.copy_(new_p if skip is None
                        else torch.where(skip, p, new_p))
            new_step = step if skip is None else torch.where(skip,
                                                             state.step, step)
            new_state = type(state)(new_step.to(torch.int32), p,
                                    state.m_shard, state.v_shard)
            # all-gather the fresh params (distributed_fused_adam.py:477),
            # optionally through the e5m2 wire
            if self.compress_allgather:
                flat_new = _comm.quantized_all_gather(
                    p, self.group, out_dtype=torch.float32,
                    scaled=self.compress_allgather == "scaled")
            else:
                flat_new = _comm.all_gather_flat(p, self.group)
            torch._foreach_copy_(
                [t.data for t in plist],
                [flat_new[o:o + n].view(s) for o, n, s in
                 zip(spec.offsets, spec.sizes, spec.shapes)])
        return new_state

    # tier-1/2 elastic checkpointing (contrib.optimizers.zero_state)
    def gather_state(self, state):
        """Topology-independent full state (see
        ``apex_tpu_torch.contrib.optimizers.zero_state``)."""
        from apex_tpu_torch.contrib.optimizers.zero_state import \
            gather_zero_state
        return gather_zero_state(self, state)

    def shard_state(self, full_state, params=None):
        """This rank's shard of a gathered state under the current group."""
        from apex_tpu_torch.contrib.optimizers.zero_state import \
            shard_zero_state
        return shard_zero_state(self, full_state, params)

    # ======================================================================
    # tier 3: per-leaf resident shards, no gather anywhere in the step
    # ======================================================================
    def _spec3(self, spec: Optional[ZeroSpec]) -> ZeroSpec:
        if spec is not None:
            self._zspec = spec
        if self._zspec is None:
            raise ValueError(
                "ZeroOptimizer(shard_params=True) needs the ZeroSpec of "
                "the resident tree — pass spec= here or at construction "
                "(ZeroShardedModel.shard builds it)")
        return self._zspec

    @staticmethod
    def _floats(tree) -> List[str]:
        return [k for k, x in tree.items() if x.is_floating_point()]

    def _init3(self, shards, spec: Optional[ZeroSpec] = None):
        self._spec3(spec)
        shards = dict(shards)
        floats = self._floats(shards)
        if not floats:
            raise ValueError("ZeroOptimizer: no floating leaf to optimize")
        dev = shards[floats[0]].device
        # always a fresh buffer: the master never aliases a shard
        flat = torch.cat([shards[k].detach().reshape(-1).float()
                          for k in floats])
        empty = lambda k, x: torch.zeros((0,), dtype=torch.float32,  # noqa
                                         device=dev)
        return Zero3State(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            master=_flat_tree(flat, shards, floats, lambda k, x: x),
            m=_flat_tree(torch.zeros_like(flat), shards, floats, empty),
            v=_flat_tree(torch.zeros_like(flat), shards, floats, empty))

    @staticmethod
    def _as_flat(state: Zero3State, shards, floats) -> Zero3State:
        """The state with master/m/v as views of flat buffers (a state
        rebuilt by ``elastic.shard_zero3_state`` is packed once)."""
        trees = (state.master, state.m, state.v)
        if all(isinstance(t, _FlatTree) and t.float_names == tuple(floats)
               for t in trees):
            return state
        flats = [torch.cat([t[k].reshape(-1) for k in floats]) for t in trees]
        return Zero3State(
            state.step,
            *(_flat_tree(f, shards, floats, lambda k, x, t=t: t[k])
              for f, t in zip(flats, trees)))

    def _masked_psum_merge(self, partials, spec: ZeroSpec):
        """Exact cross-rank per-leaf sums in ONE all-reduce: sharded
        leaves' partials are summed across ranks, replicated leaves' are
        whole already (every rank holds the same value) and count once."""
        stacked = torch.stack(partials)
        if self._world() == 1:
            return stacked
        summed = _comm.psum_flat(stacked, self.group)
        mask = self._device_tensor(
            ("mask", id(spec), stacked.device),
            lambda: torch.tensor(spec.sharded, device=stacked.device))
        return torch.where(mask, summed, stacked)

    def _leaf_sums(self, flat, sizes):
        return [part.sum() for part in flat.split(sizes)]

    def _apply3(self, state: Zero3State, shards, grads, skip=None, lr=None,
                spec: Optional[ZeroSpec] = None):
        spec = self._spec3(spec)
        world = self._world()
        lr = self._lr(lr)
        shards = dict(shards)
        floats = self._floats(shards)
        is_float = [k in floats for k in spec.names]
        sizes = [shards[k].numel() for k in floats]
        with torch.no_grad():
            if isinstance(grads, torch.Tensor):
                g = grads
                if g.dtype != torch.float32 or g.numel() != sum(sizes):
                    raise ValueError(
                        f"flat gradient shards: expected {sum(sizes)} fp32 "
                        f"values, got {g.numel()} {g.dtype}")
            else:
                g = torch.cat([grads[k].reshape(-1).float() for k in floats])
            if self.gradient_average and world > 1:
                g = g / world
            state = self._as_flat(state, shards, floats)
            p, m, v = state.master.flat, state.m.flat, state.v.flat

            def per_leaf(flat):
                sums = iter(self._leaf_sums(flat, sizes))
                zero = torch.zeros((), dtype=torch.float32, device=g.device)
                return [next(sums) if f else zero for f in is_float]

            if self.kind == "lamb":
                gsq = self._masked_psum_merge(per_leaf(g * g), spec)
                g = self._clip(g, torch.sum(gsq))
            step = state.step + 1
            out, _, _ = fused_shard_update(p, g, m, v, step, kind=self.kind,
                                           lr=lr, skip=skip, **self._hyper())
            if self.kind == "lamb":
                w_sq = self._masked_psum_merge(per_leaf(p * p), spec)
                u_sq = self._masked_psum_merge(per_leaf(out * out), spec)
                ratio = lamb_trust_ratio(torch.sqrt(w_sq), torch.sqrt(u_sq),
                                         use_nvlamb=self.use_nvlamb,
                                         weight_decay=self.weight_decay)
                idx = self._device_tensor(
                    ("floats", id(spec), tuple(floats), p.device),
                    lambda: torch.tensor(
                        [i for i, f in enumerate(is_float) if f],
                        device=p.device))
                reps = self._device_tensor(
                    ("sizes", id(spec), tuple(sizes), p.device),
                    lambda: torch.tensor(sizes, device=p.device))
                r = torch.repeat_interleave(ratio[idx], reps,
                                            output_size=p.numel())
                new_p = p - lr * r * out
                p.copy_(new_p if skip is None
                        else torch.where(skip, p, new_p))
            new_step = step if skip is None else torch.where(skip,
                                                             state.step, step)
            # fresh resident shards in the model dtypes: the fp32 master
            # cast into each shard in place (bf16 under O2). Nothing is
            # gathered: the next forward's materialization is the only
            # full-parameter traffic.
            torch._foreach_copy_([shards[k] for k in floats],
                                 [state.master[k] for k in floats])
        return shards, Zero3State(new_step.to(torch.int32), state.master,
                                  state.m, state.v)
