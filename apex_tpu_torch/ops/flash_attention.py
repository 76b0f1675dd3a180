"""Flash attention (forward and backward) and paged decode attention: CUDA
kernels beside their plain PyTorch versions.

Port of ``apex_tpu/ops/flash_attention.py``:

- :func:`flash_attention` — differentiable attention. On CUDA the forward
  replaces the Pallas ``_fwd_kernel`` (``apex_tpu/ops/flash_attention.py
  :251``) and the backward the single-pass ``_bwd_fused_kernel`` (``:604``),
  each by one of two routes chosen by :func:`sm90_route` from the dtype
  and the kernel head dim alone: ``csrc/flash_fwd_sm90.cu`` and
  ``flash_bwd_fused_sm90`` of ``csrc/flash_bwd_sm90.cu`` (wgmma/TMA; bf16
  and fp16 at head dims 64 and 128), else ``csrc/flash_fwd.cu`` and
  ``csrc/flash_bwd.cu``; on the CPU they are
  :func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`
  (the JAX ``_bwd_math``). The additive bias ([b|1, h|1, sq, sk], added to
  the scaled fp32 scores) runs in a variant of each of the wgmma route's
  and the fp32 FFMA route's kernels, the forward, the single pass and the
  split's two (read as fp32 with its broadcast dims' strides 0, never
  expanded), in the plain versions, and on the CPU through
  :class:`BiasedAttentionFunction`; its gradient is exactly zero in its own
  shape, as in the JAX package; ``frag.cuh``'s kernels raise
  (:func:`bias_refusal`). In-kernel attention dropout (the JAX kernels'
  counter hash, :func:`dropout_keep_reference`) runs in a variant of each
  of the wgmma route's and the fp32 FFMA route's kernels, the forward, the
  single pass and the split's two (chosen at compile time), and in the
  plain versions; ``frag.cuh``'s kernels raise (:func:`dropout_refusal`).
  The bias with dropout runs in a variant with both of each of the wgmma
  route's and the fp32 FFMA route's kernels. Past
  the JAX package's 2 MB VMEM gate the backward is its two-kernel split,
  which replaces ``_dkdv_kernel`` (``:558``) and ``_dq_kernel`` (``:671``)
  on the same two routes (:func:`split_route`): ``flash_dkdv_sm90`` and
  ``flash_dq_sm90`` of ``csrc/flash_bwd_sm90.cu``, else
  ``flash_dkdv_kernel`` and ``flash_dq_kernel`` of ``csrc/flash_bwd.cu``.
  fp32 operands at kernel head dims 64 and 128 that round nothing below
  fp32 take a third route, on exact-FFMA cores built into the fp32
  targets: the forward ``flash_fwd_f32_kernel`` of
  ``csrc/flash_fwd_f32.cuh`` (:func:`f32_fwd_route`), and the whole
  backward (:func:`f32_core_route`) — the single pass, the split's dk/dv
  and its dq, ``flash_bwd_f32_kernel``, ``flash_dkdv_f32_kernel`` and
  ``flash_dq_f32_kernel`` of ``csrc/flash_bwd_f32.cuh``, the split's two
  kernels reading one scratch of q and do transposed.
  :func:`uses_split_backward` is the gate, computed as the JAX package
  computes it at its default backward blocks, so the two packages route
  the same shapes the same way; the plain backward is the same function
  either way. No route gives way to another: a build or launch error
  raises.
- :func:`paged_decode_attention` — one query per sequence over the paged KV
  pool. On CUDA it launches ``csrc/paged_decode.cu``, which replaces the
  Pallas ``_paged_decode_kernel`` (``:986``) in both its modes: a bf16
  pool, or an e4m3 pool with one fp32 scale per (kv head, page); on the
  CPU it is :func:`paged_attention_reference`. One launch a call: each row's
  live keys are cut into pieces (:func:`paged_decode_pieces`) that the
  blocks of one cluster take and merge on chip.

Operands: the kernels take bf16, fp16 or fp32 (fp32 through the SIMT
product of ``csrc/frag.cuh``, for O0; the fp32 forward and backward at
kernel head dims 64 and 128 on the register-blocked FFMA cores of
``csrc/flash_fwd_f32.cuh`` and ``csrc/flash_bwd_f32.cuh``). q, k and v
may differ in dtype, as
the JAX kernels take them: the wrappers promote them to their common dtype
(exact; fp32 for any mix) and the fp32 kernels round where the JAX kernels
cast to an operand's own dtype (p to v's before the PV product; in the
backward p to dout's, ds to q's and k's; :func:`_mixed_rounds`); the output
takes q's dtype and each gradient its input's. The flash kernels are built
for head dims 32, 64, 128, 256 and 512, in every dtype; any other d up to
512 runs zero-padded to the next of them with the caller's ``scale``
(:func:`kernel_head_dim`; the zeros add nothing to a score and the padded
output columns are sliced off), and d above 512 raises. Paged decode takes
any d up to 512 (the pool is read in place, never padded), any GQA group
(past 8 in chunks of 8) and a pool of bf16, fp16 or fp32 (whatever q's
dtype) or of e4m3.

Shapes follow the JAX package: q [b, h, sq, d]; k, v [b, h, sk, d];
segment ids int32 [b, sq] ([b, sk] for kv). Paged layout: q [b, kv, group,
d]; pages [kv, num_pages, page_size, d]; block tables [b, m] int32 (page 0
is the null page); seq_lens [b] int32 (0 = inactive slot, zero output).

Masking conventions (as in the JAX package): the masked fill is ``-1e30``;
a negative segment id is padding — it matches nothing, not even another
padding id — and its output row is exactly zero; causal attention aligns
the sequence ends (``causal_offset = sk - sq``).

``flash_attention.launches`` (forward, every route),
``.wgmma_launches`` (its wgmma route alone) and ``.f32_launches`` (its
FFMA route alone), ``flash_attention_bwd.launches``
(the single-pass backward, every route), ``.wgmma_launches`` (its wgmma
route alone) and ``.f32_launches`` (its FFMA route alone),
``flash_attention_bwd.dkdv_launches`` and ``.dq_launches`` (the split,
every route), ``flash_attention_bwd.wgmma_dkdv_launches`` and
``.wgmma_dq_launches`` (the split's wgmma route alone),
``flash_attention_bwd.f32_dkdv_launches`` and ``.f32_dq_launches`` (the
split's FFMA route alone), ``flash_attention.dropout_launches`` and
``flash_attention_bwd.dropout_launches`` (the wgmma forward's and single
pass's dropout variants), ``flash_attention_bwd.dropout_dkdv_launches``
and ``.dropout_dq_launches`` (the split's dropout variants),
``flash_attention.bias_launches`` and ``flash_attention_bwd.bias_launches``
(the wgmma forward's and single pass's bias variants),
``flash_attention_bwd.bias_dkdv_launches`` and ``.bias_dq_launches`` (the
split's bias variants), ``flash_attention.bias_dropout_launches``,
``flash_attention_bwd.bias_dropout_dkdv_launches`` and
``.bias_dropout_dq_launches`` and ``.bias_dropout_fused_launches`` (the
variants with both of the forward, the split and the single pass; the
bias and dropout counters above count the variants with one alone),
``flash_attention.f32_dropout_launches`` and
``flash_attention_bwd.f32_dropout_launches`` (the FFMA forward's and single
pass's dropout variants, counted in ``.f32_launches`` too),
``flash_attention_bwd.f32_dropout_dkdv_launches`` and
``.f32_dropout_dq_launches`` (the FFMA split's dropout variants, counted in
``.f32_dkdv_launches`` and ``.f32_dq_launches`` too),
``flash_attention.f32_bias_launches``,
``flash_attention_bwd.f32_bias_launches``, ``.f32_bias_dkdv_launches`` and
``.f32_bias_dq_launches`` (the FFMA route's bias variants, counted in the
route's own counters too), ``flash_attention.f32_bias_dropout_launches``,
``flash_attention_bwd.f32_bias_dropout_launches``,
``.f32_bias_dropout_dkdv_launches`` and ``.f32_bias_dropout_dq_launches``
(the FFMA route's variants with both, counted in the route's own counters
too; the FFMA bias and dropout counters above count the variants with one
alone),
``paged_decode_attention.launches``
(bf16 pool) and ``paged_decode_attention.fp8_launches`` (e4m3 pool) count
kernel launches (the CPU path does not count).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from apex_tpu_torch._compat import (DeviceLike, check_device_type,
                                    resolve_device)
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._pad import with_padded_last_dim

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _attention_mask(sq, sk, device, causal, segment_ids_q, segment_ids_kv):
    """[b|1, 1, sq, sk] bool validity mask, or None when nothing masks."""
    mask = None
    if causal:
        qpos = torch.arange(sq, device=device)[:, None]
        kpos = torch.arange(sk, device=device)[None, :]
        mask = (kpos <= qpos + (sk - sq))[None, None]
    if segment_ids_q is not None:
        sid_kv = segment_ids_q if segment_ids_kv is None else segment_ids_kv
        seg = ((segment_ids_q[:, None, :, None] == sid_kv[:, None, None, :])
               & (segment_ids_q >= 0)[:, None, :, None])
        mask = seg if mask is None else mask & seg
    return mask


# ---------------------------------------------------------------------------
# attention dropout: the keep mask of the JAX kernels, bit for bit
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(h, c: int):
    """``h * c`` mod 2^32 for ``h`` in [0, 2^32) (a Python int or an int64
    tensor) and a 32-bit constant ``c``, in two 16-bit halves of ``c`` so
    that no int64 product overflows (torch has no uint32 arithmetic)."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """The murmur3 finalizer in uint32 arithmetic (the JAX ``_fmix32``,
    ``apex_tpu/ops/flash_attention.py:140``)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_threshold(dropout_rate: float) -> int:
    """The uint32 threshold an element's 32 hash bits must reach to be
    kept, computed on the host exactly as the JAX kernels compute it."""
    return min(int(dropout_rate * 4294967296.0), 4294967295)


def _keep_from_positions(seed: int, bi: int, hi: int, q_pos, k_pos,
                         dropout_rate: float):
    """The JAX ``_keep_from_positions`` (``:150``): a pure hash of (seed,
    batch, head, global q position, global k position), so the forward and
    the backward regenerate one mask whatever their blocks. ``seed`` is an
    int32 taken as uint32 the way ``jnp.uint32`` takes it (wrapping);
    ``hi`` an int or an int64 tensor of heads, and ``q_pos`` and ``k_pos``
    int64 tensors of non-negative positions, all broadcasting together."""
    base = _fmix32((seed & _M32) ^ _mul32(bi, 0x9E3779B1)
                   ^ _mul32(hi, 0xB5297A4D))
    h = _mul32(q_pos, 0x9E3779B1) ^ _mul32(k_pos, 0x85EBCA77) ^ base
    return _fmix32(h) >= dropout_threshold(dropout_rate)


def dropout_keep_reference(seed: int, b: int, h: int, sq: int, sk: int,
                           dropout_rate: float,
                           device: DeviceLike = None) -> torch.Tensor:
    """[b, h, sq, sk] bool keep mask exactly as the kernels generate it
    (the JAX ``dropout_keep_reference``, ``:172``), on ``device``
    (:func:`~apex_tpu_torch._compat.resolve_device`: CUDA by default)."""
    seed = int(seed)
    device = resolve_device(device)
    q_pos = torch.arange(sq, dtype=torch.int64, device=device)[:, None]
    k_pos = torch.arange(sk, dtype=torch.int64, device=device)[None, :]
    heads = torch.arange(h, dtype=torch.int64, device=device)[:, None, None]
    keep = torch.empty((b, h, sq, sk), dtype=torch.bool, device=device)
    for bi in range(b):          # a batch at a time: [h, sq, sk] int64
        keep[bi] = _keep_from_positions(seed, bi, heads, q_pos, k_pos,
                                        dropout_rate)
    return keep


def _check_dropout(dropout_rate: float, dropout_seed) -> None:
    """The JAX ``flash_attention``'s checks (``:1202-1203``,
    ``:1285-1288``): a rate in [0, 1), and a seed with a rate above 0."""
    if dropout_rate >= 1.0 or dropout_rate < 0.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if dropout_rate > 0.0 and not -2 ** 31 <= int(dropout_seed) < 2 ** 31:
        raise ValueError(f"dropout_seed must be an int32, got {dropout_seed}")


def _keep_mask(q, k, dropout_rate, dropout_seed):
    """The keep mask of attention between ``q`` and ``k`` ([b, h, s, d]),
    or None at rate 0."""
    if not dropout_rate:
        return None
    b, h, sq, _ = q.shape
    return dropout_keep_reference(dropout_seed, b, h, sq, k.shape[2],
                                  dropout_rate, device=q.device)


def _dropped(x, keep, dropout_rate):
    """``x`` [b, h, sq, sk] fp32 with the dropped elements zero and the kept
    ones times ``1 / (1 - rate)`` (``x`` itself when ``keep`` is None)."""
    if keep is None:
        return x
    return torch.where(keep, x, torch.zeros_like(x)) * (
        1.0 / (1.0 - dropout_rate))


def flash_attention_reference(q, k, v, *, causal=False, segment_ids_q=None,
                              segment_ids_kv=None, scale=None, bias=None,
                              dropout_rate=0.0, dropout_seed=None):
    """Plain attention returning ``(out, lse)`` like the forward kernel:
    fp32 scores and softmax, ``out`` in ``q.dtype``, ``lse`` fp32
    [b, h, sq] (``-1e30`` on rows that see no key). With ``dropout_rate``
    the JAX kernel's rule: the normaliser and lse take the undropped p,
    and p is masked (:func:`dropout_keep_reference` of ``dropout_seed``)
    and scaled by ``1 / (1 - rate)`` before the PV product."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    mask = _attention_mask(q.shape[2], k.shape[2], q.device, causal,
                           segment_ids_q, segment_ids_kv)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    mx = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp(s - mx)
    if mask is not None:
        # dead-row guard: a row whose max is the fill gives exp(0) = 1
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    lse = (mx + torch.log(safe_l))[..., 0]
    if dropout_rate:
        # the JAX kernel's rounding (:334-339): the dropped p, scaled up,
        # in v's dtype for the PV product (no longer exact where p is 1)
        p = _dropped(p, _keep_mask(q, k, dropout_rate, dropout_seed),
                     dropout_rate).to(v.dtype).float()
        out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / safe_l
        return out.to(q.dtype), lse
    out = torch.einsum("bhqk,bhkd->bhqd", p / safe_l, v.float())
    return out.to(q.dtype), lse


def mha_reference(q, k, v, *, causal=False, segment_ids_q=None,
                  segment_ids_kv=None, scale=None, bias=None,
                  dropout_rate=0.0, dropout_seed=None):
    """Plain multi-head attention (the JAX ``mha_reference``): fp32 math,
    output in ``q.dtype``; padding rows (segment id < 0) are zero; the
    kernels' attention dropout with ``dropout_rate``/``dropout_seed``."""
    out, _ = flash_attention_reference(
        q, k, v, causal=causal, segment_ids_q=segment_ids_q,
        segment_ids_kv=segment_ids_kv, scale=scale, bias=bias,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    return out


def _bwd_probs(q, k, lse, causal, segment_ids_q, segment_ids_kv, scale,
               bias=None):
    """The backward's fp32 probabilities p = exp(s * scale + bias - lse),
    zero where the mask is false (the JAX ``_recompute_p``)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    mask = _attention_mask(q.shape[2], k.shape[2], q.device, causal,
                           segment_ids_q, segment_ids_kv)
    if mask is None:
        return torch.exp(s - lse[..., None])
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return torch.where(mask, torch.exp(s - lse[..., None]),
                       torch.zeros_like(s))


def flash_attention_bwd_reference(q, k, v, out, lse, do, *, causal=False,
                                  segment_ids_q=None, segment_ids_kv=None,
                                  scale=None, dropout_rate=0.0,
                                  dropout_seed=None, bias=None):
    """Plain attention backward — the JAX ``_bwd_math`` operation for
    operation: p from the saved ``lse`` (zero where masked; with ``bias``,
    added to the scaled scores as ``_recompute_p`` adds it), fp32 math,
    ``(dq, dk, dv)`` in the input dtypes. With ``dropout_rate`` the JAX
    ``_p_dp_ds`` rule: dv takes the dropped p, dp is masked and rescaled,
    ds = p (dp - delta) with the undropped p, and delta = rowsum(do *
    out) of the dropped ``out``."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    p = _bwd_probs(q, k, lse, causal, segment_ids_q, segment_ids_kv, scale,
                   bias)
    keep = _keep_mask(q, k, dropout_rate, dropout_seed)
    do32 = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", _dropped(p, keep, dropout_rate),
                      do32)
    dp = _dropped(torch.einsum("bhqd,bhkd->bhqk", do32, v.float()), keep,
                  dropout_rate)
    delta = (do32 * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, out, lse, do, *, causal=False,
                           segment_ids_q=None, segment_ids_kv=None,
                           scale=None, dropout_rate=0.0, dropout_seed=None,
                           bias=None):
    """Plain version of the split's dq kernel with the delta fold (the
    wgmma route's ``flash_dq_sm90``): ``(dq, delta)``, delta = rowsum(do *
    out) fp32 [b, h, sq], computed from the forward's output as the kernel
    computes it for its own rows, then dq = (p * (dp - delta)) k * scale
    in fp32, in q's dtype. With ``dropout_rate`` the JAX ``_p_dp_ds``
    rule: dp masked and rescaled, p undropped (``out`` is the dropped
    output, as the forward gives it). ``bias`` as in
    :func:`flash_attention_bwd_reference`."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    delta = (do.float() * out.float()).sum(dim=-1)
    p = _bwd_probs(q, k, lse, causal, segment_ids_q, segment_ids_kv, scale,
                   bias)
    keep = _keep_mask(q, k, dropout_rate, dropout_seed)
    dp = _dropped(torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float()),
                  keep, dropout_rate)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    return dq.to(q.dtype), delta


def flash_bwd_dkdv_reference(q, k, v, lse, delta, do, *, causal=False,
                             segment_ids_q=None, segment_ids_kv=None,
                             scale=None, dropout_rate=0.0, dropout_seed=None,
                             bias=None):
    """Plain version of the split's dk/dv kernel: ``(dk, dv)`` from the
    forward's ``lse`` and ``delta`` [b, h, sq] (the dq kernel's, on the
    wgmma route), fp32 math, in k's and v's dtypes. With ``dropout_rate``
    the JAX ``_p_dp_ds`` rule: dv takes the dropped p, dp is masked and
    rescaled, ds = p (dp - delta) with the undropped p. ``bias`` as in
    :func:`flash_attention_bwd_reference`."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p = _bwd_probs(q, k, lse, causal, segment_ids_q, segment_ids_kv, scale,
                   bias)
    keep = _keep_mask(q, k, dropout_rate, dropout_seed)
    do32 = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", _dropped(p, keep, dropout_rate),
                      do32)
    dp = _dropped(torch.einsum("bhqd,bhkd->bhqk", do32, v.float()), keep,
                  dropout_rate)
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def paged_attention_reference(q, k_pages, v_pages, block_tables, seq_lens,
                              *, scale=None, k_scales=None, v_scales=None):
    """Plain paged decode attention: gathers each sequence's pages through
    its block table, then a masked fp32 softmax over ``seq_lens``."""
    kv_heads, _, page_size, d = k_pages.shape
    b = q.shape[0]
    m = block_tables.shape[1]
    scale = d ** -0.5 if scale is None else scale
    bt = block_tables.long()
    # [kv, b, m, page, d] -> [b, kv, m*page, d]
    k = k_pages[:, bt].transpose(0, 1).float().reshape(b, kv_heads,
                                                       m * page_size, d)
    v = v_pages[:, bt].transpose(0, 1).float().reshape(b, kv_heads,
                                                       m * page_size, d)
    if k_scales is not None:
        ks = k_scales[:, bt].transpose(0, 1)               # [b, kv, m]
        k = k / ks.repeat_interleave(page_size, dim=2)[..., None]
    if v_scales is not None:
        vs = v_scales[:, bt].transpose(0, 1)
        v = v / vs.repeat_interleave(page_size, dim=2)[..., None]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k) * scale
    pos = torch.arange(m * page_size, device=q.device)
    live = (pos[None, :] < seq_lens[:, None].long())[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, _NEG_INF))
    mx = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.where(live, torch.exp(s - mx), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", p, v) / torch.where(
        l > 0, l, torch.ones_like(l))
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

# the flash kernels' instantiations
_HEAD_DIMS = (32, 64, 128, 256, 512)
_MAX_HEAD_DIM = 512         # paged decode: any d up to this
# the kernels' dtype codes
DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def kernel_head_dim(d: int) -> int:
    """The head dim the flash kernels run ``d`` at: the next of
    ``(32, 64, 128, 256, 512)``; above 512 raises (ROADMAP §C: no larger
    head dim is instantiated; the contraction is staged in chunks, so only
    the output accumulators' registers grow with d)."""
    for kd in _HEAD_DIMS:
        if d <= kd:
            return kd
    raise ValueError(f"flash_attention kernel: head dim {d} > 512 is not "
                     "supported (the kernels are instantiated up to 512)")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check_cuda_operands(what, named, dtype, device):
    """Each named tensor lies on ``device``, is contiguous and has
    ``dtype`` (``None``: any of the kernels' bf16, fp16, fp32)."""
    for name, t in named:
        _require(t.device == device, what,
                 f"{name} lies on {t.device}, expected {device}")
        if dtype is None:
            _require(t.dtype in DTYPE_CODES, what, f"{name} has dtype "
                     f"{t.dtype}; the kernel takes bfloat16, float16 or "
                     "float32")
        else:
            _require(t.dtype == dtype, what,
                     f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
        _require(t.is_contiguous(), what, f"{name} must be contiguous")


def _promoted_dtype(*tensors) -> torch.dtype:
    """The dtype the kernels run operands of these dtypes in (exact: bf16
    and fp16 promote to fp32)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _promoted(*tensors):
    """``(tensors, dtype)`` for operands of more than one dtype: the
    tensors in their promotion, the dtype the kernels run them in."""
    dt = _promoted_dtype(*tensors)
    return tuple(t.to(dt) for t in tensors), dt


def _mixed_rounds(q, k, do):
    """The backward kernels' ``rounds`` (csrc/flash_bwd.cu): dtype codes of
    p before the dv product (dout's), ds before dk (q's) and before dq
    (k's), two bits each."""
    return (DTYPE_CODES[do.dtype] | DTYPE_CODES[q.dtype] << 2
            | DTYPE_CODES[k.dtype] << 4)


# apex_flash_fwd(q, k, v, sid_q, sid_kv, out, lse, b, h, sq, sk, d, causal,
#                scale, dtype, p_round, stream)
_FLASH_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _operand_dtype(what, q):
    _require(q.dtype in DTYPE_CODES, what,
             f"takes bfloat16, float16 or float32 operands, got {q.dtype}")
    return q.dtype


# the wgmma kernels' dropout arguments (:func:`_dropout_args`): the seed as
# uint32, the keep threshold, 1 / (1 - rate)
_DROPOUT_ARGS = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float]
# the wgmma kernels' bias arguments (:func:`_bias_operand`): the fp32 bias
# or null, its batch and head strides in elements (0 for a broadcast dim)
_BIAS_ARGS = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long]

# apex_flash_fwd_sm90(q, k, v, sid_q, sid_kv, out, lse, b, h, sq, sk, d,
#                     causal, scale, dtype, block_m, bias, bias_sb, bias_sh,
#                     seed, threshold, inv, stream): the wgmma route's
# forward, without ``p_round`` (it takes no mixed operands) and with the
# rows a block, the bias and the dropout
_SM90_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int] + _BIAS_ARGS + \
    _DROPOUT_ARGS + [ctypes.c_void_p]

# the wgmma/TMA kernels' dtypes and kernel head dims (csrc/flash_fwd_sm90.cu
# and csrc/flash_bwd_sm90.cu)
_SM90_DTYPES = (torch.bfloat16, torch.float16)
_SM90_HEAD_DIMS = (64, 128)


def sm90_route(dtype: torch.dtype, kd: int) -> bool:
    """Whether operands of ``dtype`` (after promotion) at kernel head dim
    ``kd`` (:func:`kernel_head_dim`) run the wgmma/TMA kernels: the forward
    of ``csrc/flash_fwd_sm90.cu``, the single-pass backward and the split
    of ``csrc/flash_bwd_sm90.cu`` — bf16 and fp16 at 64 and 128. Everything
    else (fp32, so mixed operands too; head dims 32, 256 and 512) runs
    ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``. The one predicate of
    both routes."""
    return dtype in _SM90_DTYPES and kd in _SM90_HEAD_DIMS


# the routes that refuse a variant, by name (ROADMAP §B1)
_FFMA_ROUTE = ("the fp32 FFMA route (f32_fwd_route / f32_core_route: "
               "csrc/flash_fwd_f32.cuh, csrc/flash_bwd_f32.cuh)")
_FRAG_ROUTE = ("the frag.cuh kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu: "
               "fp32 over narrower operands and head dims 32, 256, 512)")


def _ffma_dims(dtype: torch.dtype, kd: int) -> bool:
    return dtype == torch.float32 and kd in _F32_CORE_HEAD_DIMS


def dropout_refusal(dtype: torch.dtype, kd: int,
                    ffma: bool = True) -> Optional[str]:
    """None where the CUDA kernels take attention dropout: the wgmma route
    (:func:`sm90_route` of the promoted ``dtype`` and the kernel head dim
    ``kd``) and the fp32 FFMA route (fp32 at kernel head dims 64 and 128
    where the call runs that route, ``ffma``: :func:`f32_fwd_route` for the
    forward, :func:`f32_core_route` for the backward, so nothing is rounded
    below fp32), each in its forward, single-pass backward and split. Else
    the route that does not take it yet, by name, for the
    ``NotImplementedError`` its caller raises (ROADMAP §B1): the
    ``frag.cuh`` kernels (which also keep fp32 over narrower operands,
    ``ffma`` False)."""
    if sm90_route(dtype, kd) or (_ffma_dims(dtype, kd) and ffma):
        return None
    return _FRAG_ROUTE


def _refuse_dropout(dtype: torch.dtype, kd: int, ffma: bool = True) -> None:
    refused = dropout_refusal(dtype, kd, ffma)
    if refused is not None:
        raise NotImplementedError(f"flash_attention: attention dropout is "
                                  f"not in {refused} yet")


def bias_refusal(dtype: torch.dtype, kd: int,
                 ffma: bool = True) -> Optional[str]:
    """None where the CUDA kernels take the additive bias, with attention
    dropout or without: the wgmma route (:func:`sm90_route` of the
    promoted ``dtype`` and the kernel head dim ``kd``) and the fp32 FFMA
    route (``ffma``, as :func:`dropout_refusal` takes it), each in its
    forward, single pass and split. Else the refused route by name, for
    the ``NotImplementedError`` its caller raises (ROADMAP §B1): the
    ``frag.cuh`` kernels."""
    if sm90_route(dtype, kd) or (_ffma_dims(dtype, kd) and ffma):
        return None
    return _FRAG_ROUTE


def _refuse_bias(dtype: torch.dtype, kd: int, ffma: bool = True) -> None:
    refused = bias_refusal(dtype, kd, ffma)
    if refused is not None:
        raise NotImplementedError(f"flash_attention: the additive bias is "
                                  f"not taken by {refused} yet")


def _check_bias_shape(bias, b, h, sq, sk) -> None:
    if (bias.dim() != 4 or bias.shape[0] not in (1, b)
            or bias.shape[1] not in (1, h)
            or tuple(bias.shape[2:]) != (sq, sk)):
        raise ValueError(f"bias must broadcast to [{b}, {h}, {sq}, {sk}], "
                         f"got {tuple(bias.shape)}")


def _bias_operand(bias, b, h, sq, sk, device, scale=1.0):
    """``(fp32 bias, batch stride, head stride)`` as the wgmma and FFMA
    kernels take it, or ``(None, 0, 0)``: ``bias`` ([b|1, h|1, sq, sk], any
    float dtype) cast to fp32 without expanding a broadcast dim (a dim of
    stride 0 is taken at size 1 first), its last two dims contiguous, the
    base 16-byte aligned; the stride of a dim of size 1 is 0. The kernels add bias /
    ``scale`` to the unscaled scores, so a bias needs a nonzero scale."""
    if bias is None:
        return None, 0, 0
    what = "flash_attention kernel"
    _check_bias_shape(bias, b, h, sq, sk)
    _require(scale != 0, what, "a bias needs a nonzero scale")
    _require(bias.device == device, what,
             f"bias lies on {bias.device}, expected {device}")
    _require(bias.is_floating_point(), what,
             f"bias has dtype {bias.dtype}; a float bias is added")
    for dim in (0, 1):
        if bias.shape[dim] > 1 and bias.stride(dim) == 0:
            bias = bias.narrow(dim, 0, 1)
    bias = bias.float().contiguous()
    if bias.data_ptr() % 16:
        bias = bias.clone()
    return (bias, bias.stride(0) if bias.shape[0] > 1 else 0,
            bias.stride(1) if bias.shape[1] > 1 else 0)


def _dropout_args(dropout_rate: float, dropout_seed) -> Tuple[int, int,
                                                              float]:
    """The kernels' ``(seed, threshold, inv)``: the int32 seed as
    uint32, :func:`dropout_threshold` and ``1 / (1 - rate)`` (rounded to
    fp32 by ctypes, as the JAX kernels' weak-typed multiply rounds it).
    ``(0, 0, 1.0)`` at rate 0: threshold 0 keeps every element, and the
    kernels take their code without dropout."""
    if not dropout_rate:
        return 0, 0, 1.0
    return (int(dropout_seed) & _M32, dropout_threshold(dropout_rate),
            1.0 / (1.0 - dropout_rate))


def fwd_block_rows(bh: int, sq: int, kd: int, sms: int) -> int:
    """Query rows a block of the wgmma forward, from the shape: 64 (one
    consumer warpgroup) at kernel head dim 64, where two such blocks share
    an SM and overlap one's prologue and epilogue with the other's loop,
    and wherever ``bh * ceil(sq / 128)`` blocks of 128 rows would not fill
    ``sms`` SMs (the serve prefill's b1 h16 s512 makes 64 of them for the
    H100's 132 SMs, 128 of 64); else 128 (two consumer warpgroups, one
    block an SM)."""
    return 64 if kd == 64 or bh * -(-sq // 128) < sms else 128


# the exact-FFMA forward (csrc/flash_fwd_f32.cuh) and the split's FFMA dq
# kernel (csrc/flash_bwd_f32.cuh): fp32 operands at these kernel head dims
_F32_CORE_HEAD_DIMS = (64, 128)


def f32_fwd_route(dtype: torch.dtype, kd: int, p_round: int) -> bool:
    """Whether the forward runs the exact-FFMA kernel of
    ``csrc/flash_fwd_f32.cuh`` (built into ``flash_fwd.cu``'s fp32
    target): operands of ``dtype`` fp32 after promotion, kernel head dim
    ``kd`` 64 or 128, and ``p_round`` (the dtype code p is rounded to
    before the PV product: v's own) fp32, so nothing is rounded — over a
    narrower v the JAX kernel rounds p, and fp32 at kernel head dims 32,
    256 and 512 stays on ``flash_fwd.cu``'s kernel too. The one predicate
    of the route (:func:`sm90_route` takes bf16 and fp16)."""
    return (dtype == torch.float32 and kd in _F32_CORE_HEAD_DIMS
            and p_round == DTYPE_CODES[torch.float32])


# apex_flash_fwd_f32(q, k, v, sid_q, sid_kv, out, lse, b, h, sq, sk, d,
#                    causal, scale, bias, bias_sb, bias_sh, seed, threshold,
#                    inv, stream): the FFMA route's forward, fp32 only (no
# dtype, no ``p_round``), with the bias and the dropout
_F32_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.c_float] + _BIAS_ARGS + _DROPOUT_ARGS + [ctypes.c_void_p]


def _flash_fwd_cuda(q, k, v, segment_ids_q, segment_ids_kv, causal, scale,
                    block_rows: Optional[int] = None,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    bias=None):
    """The forward kernel. ``block_rows`` (the wgmma route only) forces 64
    or 128 query rows a block, for comparing the two at one shape; None
    takes :func:`fwd_block_rows`. Attention dropout and the additive
    ``bias`` run on the wgmma route and the fp32 FFMA route
    (:func:`dropout_refusal`, :func:`bias_refusal`), alone or together
    (each route's variant with both)."""
    what = "flash_attention kernel"
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, what,
             "q, k, v must be [b, h, s, d]")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _require(k.shape == (b, h, sk, d) and v.shape == k.shape, what,
             f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
             f"{tuple(q.shape)}")
    _check_cuda_operands(what, (("q", q), ("k", k), ("v", v)), None,
                         q.device)
    out_dtype, p_round = q.dtype, DTYPE_CODES[v.dtype]
    mixed = k.dtype != out_dtype or v.dtype != out_dtype
    if mixed:
        (q, k, v), dtype = _promoted(q, k, v)
    else:
        dtype = out_dtype
    if segment_ids_q is not None:
        if segment_ids_kv is None:
            _require(sq == sk, what, "segment_ids_kv is needed when sq != sk")
            segment_ids_kv = segment_ids_q
        _require(segment_ids_q.shape == (b, sq)
                 and segment_ids_kv.shape == (b, sk), what,
                 "segment ids must be [b, sq] and [b, sk]")
        _check_cuda_operands(what, (("segment_ids_q", segment_ids_q),
                                    ("segment_ids_kv", segment_ids_kv)),
                             torch.int32, q.device)

    kd = kernel_head_dim(d)
    sm90 = sm90_route(dtype, kd)
    f32 = f32_fwd_route(dtype, kd, p_round)
    if bias is not None:
        _refuse_bias(dtype, kd, f32)
    elif dropout_rate:
        _refuse_dropout(dtype, kd, f32)
    bias, bias_sb, bias_sh = _bias_operand(bias, b, h, sq, sk, q.device,
                                           scale)
    _require(block_rows is None or (sm90 and block_rows in (64, 128)), what,
             "block_rows takes 64 or 128, on the wgmma route only")
    if sm90 and block_rows is None:
        block_rows = fwd_block_rows(
            b * h, sq, kd, torch.cuda.get_device_properties(
                q.device).multi_processor_count)

    def launch(q, k, v):
        out = torch.empty_like(q)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        code = DTYPE_CODES[dtype]
        args = (_ptr(q), _ptr(k), _ptr(v), _ptr(segment_ids_q),
                _ptr(segment_ids_kv), _ptr(out), _ptr(lse), b, h, sq, sk,
                q.shape[-1], int(bool(causal)), float(scale), code)
        if sm90:
            fn = _build.function(_build.dtype_target("flash_fwd_sm90", code),
                                 "apex_flash_fwd_sm90", _SM90_FWD_ARGS)
            err = fn(*args, block_rows, _ptr(bias), bias_sb, bias_sh,
                     *_dropout_args(dropout_rate, dropout_seed), _stream(q))
        elif f32:
            fn = _build.function(_build.dtype_target("flash_fwd", code),
                                 "apex_flash_fwd_f32", _F32_FWD_ARGS)
            err = fn(*args[:-1], _ptr(bias), bias_sb, bias_sh,
                     *_dropout_args(dropout_rate, dropout_seed), _stream(q))
        else:
            fn = _build.function(_build.dtype_target("flash_fwd", code),
                                 "apex_flash_fwd", _FLASH_ARGS)
            err = fn(*args, p_round, _stream(q))
        _build.check(err, what)
        flash_attention.launches += 1
        if sm90:
            flash_attention.wgmma_launches += 1
            if dropout_rate and bias is not None:
                flash_attention.bias_dropout_launches += 1
            elif dropout_rate:
                flash_attention.dropout_launches += 1
            elif bias is not None:
                flash_attention.bias_launches += 1
        if f32:
            flash_attention.f32_launches += 1
            if dropout_rate and bias is not None:
                flash_attention.f32_bias_dropout_launches += 1
            elif dropout_rate:
                flash_attention.f32_dropout_launches += 1
            elif bias is not None:
                flash_attention.f32_bias_launches += 1
        return out, lse

    out, lse = with_padded_last_dim(launch, kd, (q, k, v), sliced=(0,))
    return (out.to(out_dtype) if mixed else out), lse


def flash_attention_fwd(q, k, v, segment_ids_q=None, segment_ids_kv=None,
                        causal: bool = False, scale: Optional[float] = None,
                        dropout_rate: float = 0.0, dropout_seed=None,
                        bias=None):
    """``(out, lse)`` of the attention forward: the kernel on CUDA,
    :func:`flash_attention_reference` on the CPU; ``bias`` [b|1, h|1, sq,
    sk] added to the scaled scores."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    _check_dropout(dropout_rate, dropout_seed)
    if check_device_type(q, "flash_attention") == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, segment_ids_q=segment_ids_q,
            segment_ids_kv=segment_ids_kv, scale=scale, bias=bias,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    return _flash_fwd_cuda(q, k, v, segment_ids_q, segment_ids_kv, causal,
                           scale, dropout_rate=dropout_rate,
                           dropout_seed=dropout_seed, bias=bias)


# The JAX package runs its single-pass backward while the per-(b, h) dk/dv
# accumulators (2 x [sk_p, d] fp32 plus the dk/dv blocks in their own
# dtype) fit this budget of its scoped VMEM, and the two-kernel split past
# it (``_FUSED_BWD_MAX_KV_BYTES``, apex_tpu/ops/flash_attention.py:78)
_FUSED_BWD_MAX_KV_BYTES = 2 * 1024 * 1024


def _bwd_blocks(sq: int, sk: int, causal: bool, bias: bool,
                dropout: bool):
    """The JAX package's default backward ``(block_q, block_k)`` with no
    tuned cache and no explicit blocks (``flash_attention``, :1250-1284),
    clipped to the sequence lengths as ``_flash_bwd_impl`` clips them."""
    blk = 512 if (bias and dropout) else 1024
    if causal:
        blk = min(blk, max(512, (sq // 2) // 512 * 512))
    return min(blk, sq), min(blk, sk)


def backward_kv_bytes(sq: int, sk: int, d: int, itemsize_k: int = 2,
                      itemsize_v: int = 2, causal: bool = False,
                      bias: bool = False, dropout: bool = False) -> int:
    """What the JAX package's gate (``_flash_bwd_impl``, :774-784) counts
    against its 2 MB: ``sk`` padded to the default backward block times
    ``d * (8 + itemsize_k + itemsize_v)``, plus a ``[block_q, block_k]``
    fp32 block each for bias and dropout."""
    block_q, block_k = _bwd_blocks(sq, sk, causal, bias, dropout)
    sk_p = -(-sk // block_k) * block_k
    kv_bytes = sk_p * d * (8 + itemsize_k + itemsize_v)
    if bias:
        kv_bytes += 4 * block_q * block_k
    if dropout:
        kv_bytes += 4 * block_q * block_k
    return kv_bytes


def uses_split_backward(sq: int, sk: int, d: int, itemsize_k: int = 2,
                        itemsize_v: int = 2, causal: bool = False,
                        bias: bool = False, dropout: bool = False) -> bool:
    """True where the JAX package's backward takes the two-kernel split:
    :func:`backward_kv_bytes` above 2 MB. At d64 bf16: s2048 stays
    single-pass (``sk_p`` 2048, 1.57 MB), s2049 splits (``sk_p`` 3072,
    2.36 MB)."""
    return backward_kv_bytes(sq, sk, d, itemsize_k, itemsize_v, causal,
                             bias, dropout) > _FUSED_BWD_MAX_KV_BYTES


def _bwd_route(q, k, v, causal, dropout_rate, do=None,
               split: Optional[bool] = None,
               bias: bool = False) -> Tuple[bool, torch.dtype]:
    """The backward's route, decided in one place for
    :func:`flash_attention` (before the forward, where ``do`` is not yet
    known: it takes the output's dtype, q's) and :func:`_flash_bwd_cuda`:
    ``(split, dtype)``, the two-kernel split or the single pass
    (:func:`uses_split_backward` where ``split`` is None, counting a bias
    and dropout as the JAX gate counts them) and the dtype the kernels run
    the operands in. Raises ``NotImplementedError`` where attention
    dropout or a ``bias`` is asked of a route that does not take it
    (:func:`dropout_refusal`, :func:`bias_refusal`: the route is the
    dtype's and head dim's; the wgmma and fp32 FFMA routes take either or
    both, split or not)."""
    if split is None:
        split = uses_split_backward(q.shape[2], k.shape[2], q.shape[-1],
                                    k.element_size(), v.element_size(),
                                    causal, bias=bias,
                                    dropout=bool(dropout_rate))
    do = q if do is None else do
    dtype = _promoted_dtype(q, k, v, do)
    kd = kernel_head_dim(q.shape[-1])
    ffma = f32_core_route(dtype, kd, _mixed_rounds(q, k, do))
    if bias:
        _refuse_bias(dtype, kd, ffma)
    elif dropout_rate:
        _refuse_dropout(dtype, kd, ffma)
    return split, dtype


# apex_flash_bwd(q, k, v, do, lse, delta, sid_q, sid_kv, dq_acc, turns, dk,
#                dv, b, h, sq, sk, d, causal, scale, dtype, rounds, stream)
_FLASH_BWD_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# apex_flash_bwd_dkdv(q, k, v, do, lse, delta, sid_q, sid_kv, dk, dv, b, h,
#                     sq, sk, d, causal, scale, dtype, rounds, stream), and
# apex_flash_bwd_dq(..., sid_kv, dq, b, ...) with one output pointer less
_FLASH_DKDV_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_FLASH_DQ_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# the wgmma route's apex_flash_bwd_sm90_dkdv: the same arguments without
# ``rounds`` (it takes no mixed operands), with the bias (bias, bias_sb,
# bias_sh) and the dropout (seed, threshold, inv) before the stream;
# apex_flash_bwd_sm90_dq(..., sid_kv, dq, out, b, ...) also takes the
# forward's output (the delta fold)
_SM90_DKDV_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int] + _BIAS_ARGS + _DROPOUT_ARGS + [
    ctypes.c_void_p]
_SM90_DQ_ARGS = _SM90_DKDV_ARGS

# the wgmma route's single pass, apex_flash_bwd_sm90_fused(q, k, v, do, lse,
# delta, sid_q, sid_kv, dq_acc, turns, dk, dv, b, h, sq, sk, d, causal,
# scale, dtype, bias, bias_sb, bias_sh, seed, threshold, inv, stream): the
# single pass's arguments without ``rounds``, with the bias and the dropout
_SM90_FUSED_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int] + _BIAS_ARGS + _DROPOUT_ARGS + [
    ctypes.c_void_p]

_TURN_ROWS = 64     # the single pass's query tiles: a turn counter each

# the backward's FFMA route (csrc/flash_bwd_f32.cuh) takes those head dims
# when the wrapper's roundings (``_mixed_rounds``) round nothing
_NO_ROUNDS = 0x2A       # every field 2: fp32, no rounding (csrc/flash_bwd.cu)
_F32 = "flash_bwd_f32"  # the FFMA route's name where a route is named


def f32_core_route(dtype: torch.dtype, kd: int, rounds: int) -> bool:
    """Whether the backward — the single pass, and the split's dk/dv and
    dq — runs the exact-FFMA kernels of ``csrc/flash_bwd_f32.cuh`` (built
    into ``flash_bwd.cu``'s fp32 target): operands of ``dtype`` fp32 after
    promotion, kernel head dim ``kd`` 64 or 128, and ``rounds`` (the
    wrapper's :func:`_mixed_rounds` code) rounding nothing below fp32 —
    operands whose JAX kernels round p or ds to a narrower operand's dtype
    stay on ``csrc/flash_bwd.cu``'s kernels, as fp32 at kernel head dims
    32, 256 and 512 does. The one predicate of the route: the whole fp32
    backward at those head dims runs on it."""
    return (dtype == torch.float32 and kd in _F32_CORE_HEAD_DIMS
            and rounds == _NO_ROUNDS)


def f32_core_keys(kd: int) -> int:
    """Keys a block of the FFMA route at kernel head dim ``kd``: 128 at 64;
    64 at 128, where two [128, 128] fp32 accumulators a block would not
    fit in registers beside the score tiles."""
    return 128 if kd == 64 else 64


def _route_name(route) -> str:
    """A single-pass route by name: True is the wgmma route, False
    ``csrc/flash_bwd.cu``'s, or a name (``"flash_bwd_sm90"``,
    ``"flash_bwd"``, ``"flash_bwd_f32"``)."""
    if route is True:
        return "flash_bwd_sm90"
    if route is False:
        return "flash_bwd"
    return route


def single_pass_turns(b: int, h: int, sq: int, kd: int, route) -> int:
    """The int32 turn counters the single-pass backward needs
    (``csrc/turns.cuh``): one a 64-row query tile of each (batch, head),
    times, on ``csrc/flash_bwd.cu``'s route (``route`` False), the
    kernel's gradient-column chunks a block (at most ``kd / 32``, kd the
    kernel head dim); the wgmma route (True) and the FFMA route
    (``"flash_bwd_f32"``) keep every column in one block. Each tile's dq
    is summed in a fixed order of its key tiles, so dq is the same bits on
    every run."""
    tiles = b * h * -(-sq // _TURN_ROWS)
    return tiles * (kd // 32) if _route_name(route) == "flash_bwd" \
        else tiles


def single_pass_dq_order(sq: int, sk: int, causal: bool, route,
                         kd: int = 64) -> List[List[int]]:
    """The order in which the single-pass kernels add their dq partials
    (``csrc/turns.cuh``): for each 64-row query tile, the key blocks that
    reach it, first to last. A key block reaches every query tile from the
    first whose last row sees its first key (causal: the end-aligned offset
    ``sk - sq``) to the last, so the blocks that reach a tile are blocks
    0 .. J, and every route adds them in descending order: block j after
    block j + 1, whose first tile under a causal mask is later than j's,
    so that it runs ahead of j when both are resident. Each route's grid
    runs its key blocks in reverse (the wgmma route, ``route`` True: 128
    keys a block, grid (b h, key block); ``csrc/flash_bwd.cu``, False: 64
    keys a block on the grid's fast axis; the FFMA route,
    ``"flash_bwd_f32"``: :func:`f32_core_keys` of ``kd`` a block, grid
    (b h, key block) as the wgmma route's), so a block waits only for one
    the hardware dispatched before it."""
    name = _route_name(route)
    keys = (128 if name == "flash_bwd_sm90" else
            f32_core_keys(kd) if name == _F32 else 64)
    n_qt, n_kb = -(-sq // _TURN_ROWS), -(-sk // keys)
    order = []
    for qt in range(n_qt):
        blocks = [j for j in range(n_kb)
                  if not causal
                  or max(0, keys * j - (sk - sq)) // _TURN_ROWS <= qt]
        order.append(blocks[::-1])
    return order


def _dq_workspace(q, kd: int, route):
    """``(dq_acc, turns)``: the single pass's fp32 dq accumulator in q's
    shape and its zeroed turn counters for ``route``
    (:func:`single_pass_turns`). The wgmma route and ``csrc/flash_bwd.cu``'s
    add into a zeroed accumulator, cut from one buffer with the counters
    (one zeroing pass for both); the FFMA route (``"flash_bwd_f32"``)
    writes every element (each tile's first contributor stores), so only
    its counters are zeroed."""
    b, h, sq, _ = q.shape
    if _route_name(route) == _F32:
        return (torch.empty(q.shape, dtype=torch.float32, device=q.device),
                torch.zeros(single_pass_turns(b, h, sq, kd, route),
                            dtype=torch.int32, device=q.device))
    ws = torch.zeros(q.numel() + single_pass_turns(b, h, sq, kd, route),
                     dtype=torch.float32, device=q.device)
    return ws[:q.numel()].view(q.shape), ws[q.numel():].view(torch.int32)


def split_route(dtype: torch.dtype, kd: int) -> str:
    """The source whose kernels run the backward (the two-kernel split and
    the single pass) for operands of ``dtype`` (after promotion) at kernel
    head dim ``kd`` (:func:`kernel_head_dim`): ``"flash_bwd_sm90"``
    (wgmma/TMA) where :func:`sm90_route` holds, ``"flash_bwd"`` for
    everything else (fp32, so mixed operands too; head dims 32, 256 and
    512)."""
    return "flash_bwd_sm90" if sm90_route(dtype, kd) else "flash_bwd"


def _flash_bwd_cuda(q, k, v, out, lse, do, segment_ids_q, segment_ids_kv,
                    causal, scale, split: Optional[bool] = None,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    bias=None):
    """The backward kernels. ``split=None`` routes by
    :func:`uses_split_backward`; True or False forces the two-kernel split
    or the single pass (for comparing the two at one shape). Attention
    dropout and the additive ``bias`` run on the wgmma route and the fp32
    FFMA route, split or single pass, alone or together
    (:func:`dropout_refusal`, :func:`bias_refusal`, :func:`_bwd_route`)."""
    what = "flash_attention_bwd kernel"
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, what,
             "q, k, v must be [b, h, s, d]")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _require(k.shape == (b, h, sk, d) and v.shape == k.shape
             and out.shape == q.shape and do.shape == q.shape, what,
             f"k {tuple(k.shape)} / v {tuple(v.shape)} / out / do do not "
             f"match q {tuple(q.shape)}")
    dp = kernel_head_dim(d)
    _check_cuda_operands(what, (("q", q), ("k", k), ("v", v), ("out", out),
                                ("do", do)), None, q.device)
    _require(lse.shape == (b, h, sq), what, "lse must be [b, h, sq]")
    _check_cuda_operands(what, (("lse", lse),), torch.float32, q.device)
    if segment_ids_q is not None:
        if segment_ids_kv is None:
            _require(sq == sk, what, "segment_ids_kv is needed when sq != sk")
            segment_ids_kv = segment_ids_q
        _require(segment_ids_q.shape == (b, sq)
                 and segment_ids_kv.shape == (b, sk), what,
                 "segment ids must be [b, sq] and [b, sk]")
        _check_cuda_operands(what, (("segment_ids_q", segment_ids_q),
                                    ("segment_ids_kv", segment_ids_kv)),
                             torch.int32, q.device)
    split, dtype = _bwd_route(q, k, v, causal, dropout_rate, do, split,
                              bias is not None)
    bias_op = _bias_operand(bias, b, h, sq, sk, q.device, scale)
    # mixed operands: promoted, with the JAX kernels' roundings; each
    # gradient takes its input's dtype
    dtypes = (q.dtype, k.dtype, v.dtype)
    rounds = _mixed_rounds(q, k, do)
    mixed = not q.dtype == k.dtype == v.dtype == do.dtype
    if mixed:
        q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    # delta = rowsum(do * o) in fp32: outside the kernels as in the JAX
    # package (_flash_bwd_impl), except on the split's wgmma route, whose dq
    # kernel computes it for its own rows (launched first: the delta fold),
    # and on the FFMA route, whose prologue computes it beside the
    # transposes of q and do (the single pass, and the split's dk/dv, which
    # runs before dq)
    fold = (split and split_route(dtype, dp) == "flash_bwd_sm90"
            and out.dtype == dtype)
    f32_fold = (f32_core_route(dtype, dp, rounds)
                and out.dtype == torch.float32)
    # (out is promoted inside the product: the same exact fp32 products and
    # sum as out.float(), one pass fewer)
    delta = None if fold or f32_fold else (do.float() * out).sum(dim=-1)

    drop = _dropout_args(dropout_rate, dropout_seed)

    def launch(q, k, v, do, out=None):
        dl = delta
        if fold or f32_fold:
            dl = torch.empty((b, h, sq), dtype=torch.float32,
                             device=q.device)
        if split:
            args = (q, k, v, do, lse, dl, segment_ids_q, segment_ids_kv,
                    causal, scale, rounds)
            if fold:
                dq = _flash_dq_cuda(*args, out=out, dropout=drop,
                                    bias=bias_op)
                return (dq, *_flash_dkdv_cuda(*args, dropout=drop,
                                              bias=bias_op))
            # the FFMA route: the dk/dv call's prologue transposes q and do
            # into one scratch, which the dq kernel reads after it
            ws = _f32_transposes(q) if f32_fold else None
            dk, dv = _flash_dkdv_cuda(*args, out=out, ws=ws, dropout=drop,
                                      bias=bias_op)
            return (_flash_dq_cuda(*args, ws=ws, dropout=drop, bias=bias_op),
                    dk, dv)
        sm90 = sm90_route(dtype, dp)
        f32 = f32_core_route(dtype, dp, rounds)
        dq_acc, turns = _dq_workspace(q, dp, sm90 or (_F32 if f32
                                                      else False))
        if sm90:
            dk, dv = _flash_bwd_fused_cuda(
                q, k, v, do, lse, delta, segment_ids_q, segment_ids_kv,
                causal, scale, dq_acc, turns, drop, bias_op)
            return dq_acc.to(q.dtype), dk, dv
        if f32:
            dk, dv = _flash_bwd_f32_cuda(q, k, v, do, out, lse, dl,
                                         segment_ids_q, segment_ids_kv,
                                         causal, scale, dq_acc, turns, drop,
                                         bias_op)
            return dq_acc, dk, dv
        dk = torch.empty_like(k)
        dv = torch.empty_like(v)
        fn = _build.function(_build.dtype_target(
            "flash_bwd", DTYPE_CODES[dtype]), "apex_flash_bwd",
            _FLASH_BWD_ARGS)
        err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
                 _ptr(delta), _ptr(segment_ids_q), _ptr(segment_ids_kv),
                 _ptr(dq_acc), _ptr(turns), _ptr(dk), _ptr(dv), b, h, sq,
                 sk, q.shape[-1], int(bool(causal)), float(scale),
                 DTYPE_CODES[q.dtype], rounds, _stream(q))
        _build.check(err, what)
        flash_attention_bwd.launches += 1
        return dq_acc.to(q.dtype), dk, dv

    grads = with_padded_last_dim(launch, dp, (q, k, v, do, out)
                                 if fold or f32_fold else (q, k, v, do),
                                 sliced=(0, 1, 2))
    if not mixed:
        return grads
    return tuple(g.to(dt) for g, dt in zip(grads, dtypes))


def _flash_bwd_fused_cuda(q, k, v, do, lse, delta, sid_q, sid_kv, causal,
                          scale, dq_acc, turns=None,
                          dropout=(0, 0, 1.0), bias=(None, 0, 0)):
    """The wgmma route's single pass (``flash_bwd_fused_sm90``) on operands
    ``_flash_bwd_cuda`` checked: ``(dk, dv)``, and dq times ``scale`` added
    in a fixed order into ``dq_acc`` (fp32, q's shape; the caller zeroes
    it). ``turns``: the zeroed int32 turn counters
    (:func:`single_pass_turns`), allocated here when None. ``delta`` =
    rowsum(do * out) fp32 [b, h, sq], given (``out`` the dropped output
    under dropout). ``dropout``: :func:`_dropout_args`; ``bias``:
    :func:`_bias_operand`'s ``(fp32 bias or None, batch stride, head
    stride)``, alone or with ``dropout`` (the variant with both)."""
    b, h, sq, d = q.shape
    bias_t, bias_sb, bias_sh = bias
    if turns is None:
        turns = torch.zeros(single_pass_turns(b, h, sq, d, True),
                            dtype=torch.int32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = DTYPE_CODES[q.dtype]
    fn = _build.function(_build.dtype_target("flash_bwd_sm90", code),
                         "apex_flash_bwd_sm90_fused", _SM90_FUSED_ARGS)
    _build.check(fn(_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
                    _ptr(delta), _ptr(sid_q), _ptr(sid_kv), _ptr(dq_acc),
                    _ptr(turns), _ptr(dk), _ptr(dv), b, h, sq, k.shape[2], d,
                    int(bool(causal)), float(scale), code, _ptr(bias_t),
                    bias_sb, bias_sh, *dropout, _stream(q)),
                 "flash_attention_bwd single-pass kernel")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.wgmma_launches += 1
    if dropout[1] and bias_t is not None:
        flash_attention_bwd.bias_dropout_fused_launches += 1
    elif dropout[1]:
        flash_attention_bwd.dropout_launches += 1
    elif bias_t is not None:
        flash_attention_bwd.bias_launches += 1
    return dk, dv


# apex_flash_bwd_f32(q, k, v, do, out, lse, delta, sid_q, sid_kv, ws,
#                    dq_acc, turns, dk, dv, b, h, sq, sk, d, causal, scale,
#                    bias, bias_sb, bias_sh, seed, threshold, inv, stream)
# and apex_flash_bwd_f32_dkdv(..., sid_kv, ws, dk, dv, b, ..., scale, bias,
# ..., inv, stream): the FFMA route, fp32 only, with the scratch of q and
# do transposed (no dtype, no ``rounds``), the bias and the dropout;
# ``out`` null reads a given delta
_F32_VARIANT_ARGS = [ctypes.c_float] + _BIAS_ARGS + _DROPOUT_ARGS + [
    ctypes.c_void_p]
_F32_BWD_ARGS = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + \
    _F32_VARIANT_ARGS
_F32_DKDV_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + \
    _F32_VARIANT_ARGS
# apex_flash_bwd_f32_dq(q, k, v, do, lse, delta, sid_q, sid_kv, ws,
#                       transposed, dq, b, h, sq, sk, d, causal, scale, bias,
#                       bias_sb, bias_sh, seed, threshold, inv, stream): the
# split's FFMA dq; ``transposed`` 1 when ws already holds q and do
# transposed
_F32_DQ_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p] + [
    ctypes.c_int] * 6 + _F32_VARIANT_ARGS


def _f32_transposes(q):
    """The FFMA route's scratch: q and do transposed, [2, b, h, d, sqp]
    fp32 with sqp = sq rounded up to 4 (16-byte rows); the kernels write
    every element they read."""
    b, h, sq, d = q.shape
    return torch.empty(2 * b * h * d * (-(-sq // 4) * 4),
                       dtype=torch.float32, device=q.device)


def _f32_call(symbol, q, k, v, do, out, lse, delta, sid_q, sid_kv, causal,
              scale, outs, ws=None, dropout=(0, 0, 1.0),
              bias=(None, 0, 0)):
    """One C call of the FFMA route's single pass or split dk/dv
    (``symbol`` with its argument types) on fp32 operands
    ``_flash_bwd_cuda`` checked: the prologue (the transposes of q and do
    into ``ws``, :func:`_f32_transposes`, allocated here when None; and
    with ``out``, the forward's fp32 output, delta written into
    ``delta``), then the kernel or its variant; ``outs`` the output
    pointers after the scratch, ``dropout`` :func:`_dropout_args` and
    ``bias`` :func:`_bias_operand`'s triple (either, both or neither)."""
    b, h, sq, d = q.shape
    _require(out is None or (out.dtype == torch.float32
                             and out.shape == q.shape
                             and out.is_contiguous()),
             "flash_attention_bwd FFMA route", "the delta fold takes an fp32 "
             "output of q's shape")
    name, argtypes = symbol
    fn = _build.function(_build.dtype_target("flash_bwd", 2), name, argtypes)
    if ws is None:
        ws = _f32_transposes(q)
    _build.check(fn(_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(out),
                    _ptr(lse), _ptr(delta), _ptr(sid_q), _ptr(sid_kv),
                    _ptr(ws), *outs,
                    b, h, sq, k.shape[2], d, int(bool(causal)), float(scale),
                    _ptr(bias[0]), *bias[1:], *dropout, _stream(q)),
                 f"flash_attention_bwd {name}")


def _flash_bwd_f32_cuda(q, k, v, do, out, lse, delta, sid_q, sid_kv, causal,
                        scale, dq_acc, turns, dropout=(0, 0, 1.0),
                        bias=(None, 0, 0)):
    """The FFMA route's single pass (``flash_bwd_f32_kernel``; with
    ``dropout``, :func:`_dropout_args`, its variant
    ``flash_bwd_f32_dropout_kernel``; with ``bias``,
    :func:`_bias_operand`'s triple, ``flash_bwd_f32_bias_kernel``; with
    both, ``flash_bwd_f32_bias_dropout_kernel``) on fp32
    operands ``_flash_bwd_cuda`` checked, at kernel head dim 64 or 128:
    ``(dk, dv)``, and dq times
    ``scale`` written into ``dq_acc`` (fp32, q's shape; every element:
    each query tile's key blocks add in a fixed order, the first storing).
    ``turns``: the zeroed int32 turn counters (:func:`single_pass_turns`).
    The call writes delta = rowsum(do * out) (fp32 [b, h, sq]) into
    ``delta`` from ``out``, the forward's output (the dropped one under
    dropout)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _f32_call(("apex_flash_bwd_f32", _F32_BWD_ARGS), q, k, v, do, out, lse,
              delta, sid_q, sid_kv, causal, scale,
              (_ptr(dq_acc), _ptr(turns), _ptr(dk), _ptr(dv)),
              dropout=dropout, bias=bias)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.f32_launches += 1
    if dropout[1] and bias[0] is not None:
        flash_attention_bwd.f32_bias_dropout_launches += 1
    elif dropout[1]:
        flash_attention_bwd.f32_dropout_launches += 1
    elif bias[0] is not None:
        flash_attention_bwd.f32_bias_launches += 1
    return dk, dv


def _refuse_split_variants(q, rounds, dropout, bias) -> None:
    """Raises ``NotImplementedError`` before a split kernel's call where
    its route does not take the ``dropout`` or the ``bias`` it is given
    (:func:`dropout_refusal`, :func:`bias_refusal`, ``rounds`` telling the
    FFMA route from ``frag.cuh``): the wgmma and FFMA routes take either
    and both."""
    ffma = f32_core_route(q.dtype, q.shape[-1], rounds)
    if bias[0] is not None:
        _refuse_bias(q.dtype, q.shape[-1], ffma)
    elif dropout[1]:
        _refuse_dropout(q.dtype, q.shape[-1], ffma)


def _split_operands(q, k, v, do, lse, delta, sid_q, sid_kv, causal, scale,
                    rounds, dropout, bias):
    """``(route, operands, tail)`` of a split kernel's C call: the route
    (:func:`split_route`), the eight input pointers, and the sizes, flags,
    the wgmma route's ``bias`` (:func:`_bias_operand`) and ``dropout``
    (:func:`_dropout_args`) and the stream after the output pointers."""
    b, h, sq, d = q.shape
    route = split_route(q.dtype, d)
    tail = (b, h, sq, k.shape[2], d, int(bool(causal)), float(scale),
            DTYPE_CODES[q.dtype])
    if route == "flash_bwd_sm90":
        bias_t, bias_sb, bias_sh = bias
        tail += (_ptr(bias_t), bias_sb, bias_sh, *dropout, _stream(q))
    else:
        tail += (rounds, _stream(q))
    return route, (_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
                   _ptr(delta), _ptr(sid_q), _ptr(sid_kv)), tail


def _flash_dkdv_cuda(q, k, v, do, lse, delta, sid_q, sid_kv, causal, scale,
                     rounds, out=None, ws=None, dropout=(0, 0, 1.0),
                     bias=(None, 0, 0)):
    """The split's dk/dv kernel on operands ``_flash_bwd_cuda`` checked and
    promoted; ``delta`` = rowsum(do * out) fp32 [b, h, sq] (``out`` the
    dropped output under dropout). The FFMA
    route's (``flash_dkdv_f32_kernel``) where :func:`f32_core_route`
    holds; there, given ``out`` (the forward's output), the call computes
    delta and writes it into ``delta`` for the dq kernel after it, and its
    prologue writes q and do transposed into ``ws``
    (:func:`_f32_transposes`; allocated here when None), which the dq
    kernel after it may read (:func:`_flash_dq_cuda`'s ``ws``).
    ``dropout``: :func:`_dropout_args`; ``bias``: :func:`_bias_operand`'s
    ``(fp32 bias or None, batch stride, head stride)``, alone or with
    ``dropout`` (each route's variant with both)."""
    _refuse_split_variants(q, rounds, dropout, bias)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if f32_core_route(q.dtype, q.shape[-1], rounds):
        _f32_call(("apex_flash_bwd_f32_dkdv", _F32_DKDV_ARGS), q, k, v, do,
                  out, lse, delta, sid_q, sid_kv, causal, scale,
                  (_ptr(dk), _ptr(dv)), ws, dropout, bias)
        flash_attention_bwd.dkdv_launches += 1
        flash_attention_bwd.f32_dkdv_launches += 1
        if dropout[1] and bias[0] is not None:
            flash_attention_bwd.f32_bias_dropout_dkdv_launches += 1
        elif dropout[1]:
            flash_attention_bwd.f32_dropout_dkdv_launches += 1
        elif bias[0] is not None:
            flash_attention_bwd.f32_bias_dkdv_launches += 1
        return dk, dv
    _require(out is None and ws is None, "flash_attention_bwd dk/dv kernel",
             "only the FFMA route folds delta into the dk/dv call and "
             "transposes q and do")
    route, operands, tail = _split_operands(q, k, v, do, lse, delta, sid_q,
                                            sid_kv, causal, scale, rounds,
                                            dropout, bias)
    sm90 = route == "flash_bwd_sm90"
    fn = _build.function(
        _build.dtype_target(route, DTYPE_CODES[q.dtype]),
        "apex_flash_bwd_sm90_dkdv" if sm90 else "apex_flash_bwd_dkdv",
        _SM90_DKDV_ARGS if sm90 else _FLASH_DKDV_ARGS)
    _build.check(fn(*operands, _ptr(dk), _ptr(dv), *tail),
                 "flash_attention_bwd dk/dv kernel")
    flash_attention_bwd.dkdv_launches += 1
    if sm90:
        flash_attention_bwd.wgmma_dkdv_launches += 1
        if dropout[1] and bias[0] is not None:
            flash_attention_bwd.bias_dropout_dkdv_launches += 1
        elif dropout[1]:
            flash_attention_bwd.dropout_dkdv_launches += 1
        elif bias[0] is not None:
            flash_attention_bwd.bias_dkdv_launches += 1
    return dk, dv


def _flash_dq_cuda(q, k, v, do, lse, delta, sid_q, sid_kv, causal, scale,
                   rounds, out=None, ws=None, dropout=(0, 0, 1.0),
                   bias=(None, 0, 0)):
    """The split's dq kernel, as :func:`_flash_dkdv_cuda`. With ``out``
    (the forward's output, q's dtype; the wgmma route only) the kernel
    computes delta itself and writes it into ``delta``. The FFMA route's
    (``flash_dq_f32_kernel``) where :func:`f32_core_route` holds; there
    ``ws`` is the scratch the dk/dv call before it filled with q and do
    transposed (the split passes it), or None: this call's own prologue
    transposes them first. ``dropout`` and ``bias`` as
    :func:`_flash_dkdv_cuda` takes them."""
    _refuse_split_variants(q, rounds, dropout, bias)
    dq = torch.empty_like(q)
    if f32_core_route(q.dtype, q.shape[-1], rounds):
        _require(out is None, "flash_attention_bwd dq kernel", "the FFMA "
                 "route's dq reads delta (the dk/dv call folds it)")
        b, h, sq, d = q.shape
        fn = _build.function(_build.dtype_target("flash_bwd", 2),
                             "apex_flash_bwd_f32_dq", _F32_DQ_ARGS)
        _build.check(fn(_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
                        _ptr(delta), _ptr(sid_q), _ptr(sid_kv),
                        _ptr(_f32_transposes(q) if ws is None else ws),
                        int(ws is not None), _ptr(dq), b, h, sq, k.shape[2],
                        d, int(bool(causal)), float(scale), _ptr(bias[0]),
                        *bias[1:], *dropout, _stream(q)),
                     "flash_attention_bwd apex_flash_bwd_f32_dq")
        flash_attention_bwd.dq_launches += 1
        flash_attention_bwd.f32_dq_launches += 1
        if dropout[1] and bias[0] is not None:
            flash_attention_bwd.f32_bias_dropout_dq_launches += 1
        elif dropout[1]:
            flash_attention_bwd.f32_dropout_dq_launches += 1
        elif bias[0] is not None:
            flash_attention_bwd.f32_bias_dq_launches += 1
        return dq
    _require(ws is None, "flash_attention_bwd dq kernel",
             "only the FFMA route reads transposed q and do")
    route, operands, tail = _split_operands(q, k, v, do, lse, delta, sid_q,
                                            sid_kv, causal, scale, rounds,
                                            dropout, bias)
    sm90 = route == "flash_bwd_sm90"
    _require(out is None or (sm90 and out.dtype == q.dtype
                             and out.shape == q.shape
                             and out.is_contiguous()),
             "flash_attention_bwd dq kernel",
             "the delta fold takes the wgmma route's operands and an "
             "output of q's dtype and shape")
    fn = _build.function(
        _build.dtype_target(route, DTYPE_CODES[q.dtype]),
        "apex_flash_bwd_sm90_dq" if sm90 else "apex_flash_bwd_dq",
        _SM90_DQ_ARGS if sm90 else _FLASH_DQ_ARGS)
    outs = (_ptr(dq), _ptr(out)) if sm90 else (_ptr(dq),)
    _build.check(fn(*operands, *outs, *tail),
                 "flash_attention_bwd dq kernel")
    flash_attention_bwd.dq_launches += 1
    if sm90:
        flash_attention_bwd.wgmma_dq_launches += 1
        if dropout[1] and bias[0] is not None:
            flash_attention_bwd.bias_dropout_dq_launches += 1
        elif dropout[1]:
            flash_attention_bwd.dropout_dq_launches += 1
        elif bias[0] is not None:
            flash_attention_bwd.bias_dq_launches += 1
    return dq


# apex_wgmma_rs_probe(a, b, c, n, k, b_mn, dtype, stream)
_RS_PROBE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]


def wgmma_rs_probe(a: torch.Tensor, b: torch.Tensor,
                   b_mn: bool) -> torch.Tensor:
    """The register-A product of ``csrc/wgmma_attn.cuh`` alone, for the
    card test of its descriptors: fp32 [64, n] = ``a`` [64, k] times B,
    where ``b`` is B^T [n, k] (K-major) or, with ``b_mn``, B [k, n]
    (MN-major); bf16 or fp16, n and k each 64 or 128. A is loaded into the
    m64k16 register fragments, B by one TMA."""
    what = "wgmma_rs_probe"
    n, k = (b.shape[1], b.shape[0]) if b_mn else tuple(b.shape)
    _require(a.shape == (64, k) and n in (64, 128) and k in (64, 128), what,
             f"a {tuple(a.shape)} / b {tuple(b.shape)}: want a [64, k] and "
             "n, k in (64, 128)")
    _check_cuda_operands(what, (("a", a), ("b", b)), a.dtype, a.device)
    _require(a.dtype in _SM90_DTYPES, what, "takes bfloat16 or float16")
    c = torch.empty((64, n), dtype=torch.float32, device=a.device)
    fn = _build.function(_build.dtype_target(
        "flash_bwd_sm90", DTYPE_CODES[a.dtype]), "apex_wgmma_rs_probe",
        _RS_PROBE_ARGS)
    _build.check(fn(_ptr(a), _ptr(b), _ptr(c), n, k, int(bool(b_mn)),
                    DTYPE_CODES[a.dtype], _stream(a)), what)
    return c


def flash_attention_bwd(q, k, v, out, lse, do, segment_ids_q=None,
                        segment_ids_kv=None, causal: bool = False,
                        scale: Optional[float] = None,
                        dropout_rate: float = 0.0, dropout_seed=None,
                        bias=None):
    """``(dq, dk, dv)`` of the attention from the forward's ``out`` and
    ``lse``: on CUDA the single-pass kernel, or past the JAX package's gate
    (:func:`uses_split_backward`) the dk/dv kernel then the dq kernel; on
    the CPU :func:`flash_attention_bwd_reference`.
    ``flash_attention_bwd.launches`` counts single-pass launches
    (``.wgmma_launches`` those on the wgmma route, ``.f32_launches`` those
    on the FFMA route, ``.f32_dropout_launches`` those with dropout),
    ``.dkdv_launches`` and ``.dq_launches`` the split's
    (``.f32_dkdv_launches`` and ``.f32_dq_launches`` those on the FFMA
    route, ``.f32_dropout_dkdv_launches`` and ``.f32_dropout_dq_launches``
    those with dropout, ``.f32_bias_launches``, ``.f32_bias_dkdv_launches``
    and ``.f32_bias_dq_launches`` the FFMA single passes and split
    launches with a bias, ``.f32_bias_dropout_launches``,
    ``.f32_bias_dropout_dkdv_launches`` and ``.f32_bias_dropout_dq_launches``
    those with both, which count there alone); on the wgmma route
    ``.dropout_launches`` the single passes with dropout,
    ``.dropout_dkdv_launches`` and ``.dropout_dq_launches``
    the split's, ``.bias_launches`` the single passes with a bias,
    ``.bias_dkdv_launches`` and ``.bias_dq_launches`` the split's,
    ``.bias_dropout_fused_launches`` the single passes with both,
    ``.bias_dropout_dkdv_launches`` and ``.bias_dropout_dq_launches`` the
    split's (a launch with both counts there alone).
    ``dropout_rate``/``dropout_seed`` and ``bias`` are the forward's: the
    kernel regenerates its mask and recomputes p with the bias."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    _check_dropout(dropout_rate, dropout_seed)
    if check_device_type(q, "flash_attention_bwd") == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=causal,
            segment_ids_q=segment_ids_q, segment_ids_kv=segment_ids_kv,
            scale=scale, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, bias=bias)
    return _flash_bwd_cuda(q, k, v, out, lse, do, segment_ids_q,
                           segment_ids_kv, causal, scale,
                           dropout_rate=dropout_rate,
                           dropout_seed=dropout_seed, bias=bias)


flash_attention_bwd.launches = 0
flash_attention_bwd.wgmma_launches = 0
flash_attention_bwd.dkdv_launches = 0
flash_attention_bwd.dq_launches = 0
flash_attention_bwd.wgmma_dkdv_launches = 0
flash_attention_bwd.wgmma_dq_launches = 0
flash_attention_bwd.f32_launches = 0
flash_attention_bwd.f32_dkdv_launches = 0
flash_attention_bwd.f32_dq_launches = 0
flash_attention_bwd.f32_dropout_launches = 0
flash_attention_bwd.f32_dropout_dkdv_launches = 0
flash_attention_bwd.f32_dropout_dq_launches = 0
flash_attention_bwd.f32_bias_launches = 0
flash_attention_bwd.f32_bias_dkdv_launches = 0
flash_attention_bwd.f32_bias_dq_launches = 0
flash_attention_bwd.f32_bias_dropout_launches = 0
flash_attention_bwd.f32_bias_dropout_dkdv_launches = 0
flash_attention_bwd.f32_bias_dropout_dq_launches = 0
flash_attention_bwd.dropout_launches = 0
flash_attention_bwd.dropout_dkdv_launches = 0
flash_attention_bwd.dropout_dq_launches = 0
flash_attention_bwd.bias_launches = 0
flash_attention_bwd.bias_dkdv_launches = 0
flash_attention_bwd.bias_dq_launches = 0
flash_attention_bwd.bias_dropout_fused_launches = 0
flash_attention_bwd.bias_dropout_dkdv_launches = 0
flash_attention_bwd.bias_dropout_dq_launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Forward kernel + backward kernel as one differentiable op. Saves
    ``(q, k, v, out, lse)``, the segment ids and the bias, and carries the
    dropout rate and seed to the backward, which regenerates the mask
    (with a bias too: the variants with both of the forward, the single
    pass and the split); segment ids get no gradient, the bias an exactly
    zero one in its own shape (the JAX ``_fa_bwd``'s ``zeros_like(bias)``:
    an additive mask, non-differentiable by contract)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids_q, segment_ids_kv, causal, scale,
                dropout_rate, dropout_seed, bias=None):
        out, lse = flash_attention_fwd(q, k, v, segment_ids_q,
                                       segment_ids_kv, causal, scale,
                                       dropout_rate, dropout_seed, bias)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids_q,
                              segment_ids_kv, bias)
        ctx.causal, ctx.scale = causal, scale
        ctx.dropout = (dropout_rate, dropout_seed)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, sid_q, sid_kv, bias = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         sid_q, sid_kv, ctx.causal,
                                         ctx.scale, *ctx.dropout, bias=bias)
        dbias = torch.zeros_like(bias) if ctx.needs_input_grad[9] else None
        return dq, dk, dv, None, None, None, None, None, None, dbias


class BiasedAttentionFunction(torch.autograd.Function):
    """The plain attention under an additive bias (the CPU route): the
    gradients of q, k and v are autograd's through
    :func:`mha_reference`, and the bias's is exactly zero in its own shape
    (the JAX op's ``dbias = zeros_like(bias)``, ``_fa_bwd``: the bias is
    an additive mask, non-differentiable by contract); with the kernels'
    attention dropout where ``dropout_rate`` is above 0."""

    @staticmethod
    def forward(ctx, q, k, v, bias, segment_ids_q, segment_ids_kv, causal,
                scale, dropout_rate, dropout_seed):
        ctx.save_for_backward(q, k, v, bias, segment_ids_q, segment_ids_kv)
        ctx.causal, ctx.scale = causal, scale
        ctx.dropout = dict(dropout_rate=dropout_rate,
                           dropout_seed=dropout_seed)
        return mha_reference(q, k, v, causal=causal,
                             segment_ids_q=segment_ids_q,
                             segment_ids_kv=segment_ids_kv, scale=scale,
                             bias=bias, **ctx.dropout)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, sid_q, sid_kv = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = mha_reference(*qkv, causal=ctx.causal,
                                segment_ids_q=sid_q, segment_ids_kv=sid_kv,
                                scale=ctx.scale, bias=bias.detach(),
                                **ctx.dropout)
            dq, dk, dv = torch.autograd.grad(out, qkv, do)
        dbias = torch.zeros_like(bias) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias, None, None, None, None, None, None


def flash_attention(q, k, v, segment_ids_q=None, segment_ids_kv=None,
                    causal: bool = False, scale: Optional[float] = None,
                    bias=None, dropout_rate: float = 0.0, dropout_seed=None):
    """Fused attention, differentiable in ``q``, ``k`` and ``v``. Returns
    [b, h, sq, d] in ``q.dtype``.

    ``segment_ids_*``: tokens attend only within equal non-negative ids;
    negative ids are padding and give zero rows. ``bias`` ([b|1, h|1, sq,
    sk], any float dtype, added to the scaled fp32 scores; -inf entries
    allowed) gets an exactly zero gradient, as in the JAX package. On CUDA
    the wgmma route's and the fp32 FFMA route's forward and backward take
    it, single pass and split (:class:`FlashAttentionFunction`);
    ``frag.cuh``'s kernels raise ``NotImplementedError`` naming the route
    (:func:`bias_refusal`), before the forward where the backward's route
    would refuse it. With dropout too, the wgmma route's and the FFMA
    route's forward, single pass and split each run their variant with
    both (the JAX gate, which with both counts 512-row blocks, splits bf16
    from s467 at d 64 and s425 at d 128, fp32 from s452 at d 64 and s400
    at d 128, causal or not). On the CPU it
    runs through the plain version (:class:`BiasedAttentionFunction`).

    ``dropout_rate``/``dropout_seed`` (an int32): in-kernel attention
    dropout, the keep mask a hash of (seed, batch, head, q position, k
    position) that the backward regenerates
    (:func:`dropout_keep_reference`, bit for bit the JAX package's); pass a
    fresh seed a step. On CUDA the wgmma route's and the fp32 FFMA route's
    (fp32 operands at kernel head dims 64 and 128) forward and backward,
    single pass and split, take it; ``frag.cuh``'s kernels raise
    ``NotImplementedError`` naming themselves (:func:`dropout_refusal`),
    before the forward where the backward's route would refuse it."""
    _check_dropout(dropout_rate, dropout_seed)
    dropout_rate = float(dropout_rate)
    dropout_seed = int(dropout_seed) if dropout_rate > 0 else None
    cuda = check_device_type(q, "flash_attention") == "cuda"
    if bias is not None:
        _check_bias_shape(bias, q.shape[0], q.shape[1], q.shape[2],
                          k.shape[2])
        if not cuda:
            return BiasedAttentionFunction.apply(
                q, k, v, bias, segment_ids_q, segment_ids_kv, bool(causal),
                scale, dropout_rate, dropout_seed)
    if cuda and (dropout_rate or bias is not None) \
            and torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
        _bwd_route(q, k, v, bool(causal), dropout_rate,
                   bias=bias is not None)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return FlashAttentionFunction.apply(q, k, v, segment_ids_q,
                                        segment_ids_kv, bool(causal), scale,
                                        dropout_rate, dropout_seed, bias)


flash_attention.launches = 0
flash_attention.wgmma_launches = 0
flash_attention.f32_launches = 0
flash_attention.f32_dropout_launches = 0
flash_attention.f32_bias_launches = 0
flash_attention.f32_bias_dropout_launches = 0
flash_attention.dropout_launches = 0
flash_attention.bias_launches = 0
flash_attention.bias_dropout_launches = 0


# apex_paged_decode(q, k_pages, v_pages, k_scales, v_scales, block_tables,
#                   seq_lens, out, b, kv, group, d, num_pages, page_size, m,
#                   scale, dtype, pool_dtype, splits, granule, stream)
_PAGED_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
    ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# The cut of a row, chosen by measurement on the H100 (PERF.md, §6):
# clusters of 4 launch and drain faster than clusters of 8 at the serve
# engine's batch of 8 rows x 16 kv heads, and 16-key granules cut a
# speculative draft or verify row into four busy pieces
_DECODE_SPLITS = 4        # pieces of a row at most: the blocks of a cluster
_DECODE_GRANULE = 16      # a piece's keys, in whole multiples of this


def paged_decode_split_plan(page_size: int, d: int,
                            pool_dtype: torch.dtype) -> Tuple[int, int]:
    """``(splits, granule)`` of the paged decode kernel's cut of a row: at
    most ``splits`` pieces of whole ``granule``s of keys (at least the keys
    a block scores in one step at ``d``'s instantiation). Constants of
    (page_size, d, pool dtype) alone, never of the batch."""
    dp = kernel_head_dim(d)
    lanes = dp // (16 if dp > 256 else 8)        # lanes of one key row
    step = 4 * (32 // lanes)                     # keys of a block step
    return _DECODE_SPLITS, max(_DECODE_GRANULE, step)


def paged_decode_pieces(seq_len: int, page_size: int, d: int,
                        pool_dtype: torch.dtype) -> List[Tuple[int, int]]:
    """The key ranges ``[lo, hi)`` the kernel cuts a row of ``seq_len``
    live keys into, in the order it merges them: ``c = ceil(seq_len /
    splits)`` rounded up to the granule, block r taking ``[r c, (r + 1)
    c)``; a row of no key has none. (The kernel first clamps seq_len to
    the keys its block-table row holds.)"""
    if seq_len <= 0:
        return []
    splits, granule = paged_decode_split_plan(page_size, d, pool_dtype)
    c = -(-seq_len // splits)
    c = -(-c // granule) * granule
    return [(lo, min(seq_len, lo + c)) for lo in range(0, seq_len, c)]


def _paged_decode_cuda(q, k_pages, v_pages, block_tables, seq_lens, scale,
                       k_scales, v_scales):
    what = "paged_decode_attention kernel"
    fp8 = k_scales is not None
    b, kv, group, d = q.shape
    _, num_pages, page_size, _ = k_pages.shape
    m = block_tables.shape[1]
    dtype = _operand_dtype(what, q)
    _require(0 < d <= _MAX_HEAD_DIM, what,
             f"head dim {d} is past {_MAX_HEAD_DIM} (the kernel is "
             "instantiated up to 512)")
    _require(v_pages.shape == k_pages.shape, what,
             "k_pages and v_pages differ in shape")
    _require(block_tables.shape == (b, m) and seq_lens.shape == (b,), what,
             "block_tables must be [b, m] and seq_lens [b]")
    _check_cuda_operands(what, (("q", q),), dtype, q.device)
    pool_dtype = torch.float8_e4m3fn if fp8 else k_pages.dtype
    _require(fp8 or pool_dtype in DTYPE_CODES, what, f"k_pages has dtype "
             f"{pool_dtype}; the kernel takes bfloat16, float16 or float32")
    _check_cuda_operands(what, (("k_pages", k_pages), ("v_pages", v_pages)),
                         pool_dtype, q.device)
    if fp8:
        _require(k_scales.shape == (kv, num_pages)
                 and v_scales.shape == (kv, num_pages), what,
                 f"fp8 scales must be [kv={kv}, num_pages={num_pages}]")
        _check_cuda_operands(what, (("k_scales", k_scales),
                                    ("v_scales", v_scales)),
                             torch.float32, q.device)
    _check_cuda_operands(what, (("block_tables", block_tables),
                                ("seq_lens", seq_lens)),
                         torch.int32, q.device)
    out = torch.empty_like(q)
    fn = _build.function(_build.dtype_target(
        "paged_decode", DTYPE_CODES[dtype]), "apex_paged_decode", _PAGED_ARGS)
    err = fn(_ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scales),
             _ptr(v_scales), _ptr(block_tables), _ptr(seq_lens), _ptr(out),
             b, kv, group, d, num_pages, page_size, m, float(scale),
             DTYPE_CODES[dtype], 0 if fp8 else DTYPE_CODES[k_pages.dtype],
             *paged_decode_split_plan(page_size, d, pool_dtype), _stream(q))
    _build.check(err, what)
    if fp8:
        paged_decode_attention.fp8_launches += 1
    else:
        paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                           scale: Optional[float] = None,
                           k_scales=None, v_scales=None):
    """Paged single-query (decode) attention, GQA-aware. Returns
    ``[b, kv_heads, group, d]`` in ``q.dtype`` (layout in the module
    docstring). ``k_scales``/``v_scales`` ([kv_heads, num_pages] fp32) arm
    the fp8-KV mode: the pages hold e4m3 values, each page quantized with
    its own scale. The kernel on CUDA, :func:`paged_attention_reference` on
    the CPU. ``paged_decode_attention.launches`` counts the bf16 kernel's
    launches and ``.fp8_launches`` the fp8 variant's."""
    b, kv_heads, group, d = q.shape
    kvp, _, _, dp = k_pages.shape
    if (kvp, dp) != (kv_heads, d):
        raise ValueError(
            f"k_pages {tuple(k_pages.shape)} does not match q "
            f"{tuple(q.shape)}: want [kv_heads={kv_heads}, num_pages, "
            f"page_size, d={d}]")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("fp8-KV mode needs BOTH k_scales and v_scales")
    scale = d ** -0.5 if scale is None else float(scale)
    if check_device_type(q, "paged_decode_attention") == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         seq_lens, scale=scale,
                                         k_scales=k_scales,
                                         v_scales=v_scales)
    return _paged_decode_cuda(q, k_pages, v_pages, block_tables, seq_lens,
                              scale, k_scales, v_scales)


paged_decode_attention.launches = 0
paged_decode_attention.fp8_launches = 0
