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
  (the JAX ``_bwd_math``). The additive bias runs through the plain version
  on the CPU, with an exactly zero gradient of its own as in the JAX
  package, and raises on CUDA; in-kernel dropout is not ported yet. Past
  the JAX package's 2 MB VMEM gate the backward is its two-kernel split,
  which replaces ``_dkdv_kernel`` (``:558``) and ``_dq_kernel`` (``:671``)
  on the same two routes (:func:`split_route`): ``flash_dkdv_sm90`` and
  ``flash_dq_sm90`` of ``csrc/flash_bwd_sm90.cu``, else
  ``flash_dkdv_kernel`` and ``flash_dq_kernel`` of ``csrc/flash_bwd.cu``.
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
product of ``csrc/frag.cuh``, for O0). q, k and v may differ in dtype, as
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

``flash_attention.launches`` (forward, either route) and
``.wgmma_launches`` (its wgmma route alone), ``flash_attention_bwd.launches``
(the single-pass backward, either route) and ``.wgmma_launches`` (its
wgmma route alone), ``flash_attention_bwd.dkdv_launches`` and
``.dq_launches`` (the split, either route),
``flash_attention_bwd.wgmma_dkdv_launches`` and ``.wgmma_dq_launches``
(the split's wgmma route alone), ``paged_decode_attention.launches``
(bf16 pool) and ``paged_decode_attention.fp8_launches`` (e4m3 pool) count
kernel launches (the CPU path does not count).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from apex_tpu_torch._compat import check_device_type
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


def flash_attention_reference(q, k, v, *, causal=False, segment_ids_q=None,
                              segment_ids_kv=None, scale=None, bias=None):
    """Plain attention returning ``(out, lse)`` like the forward kernel:
    fp32 scores and softmax, ``out`` in ``q.dtype``, ``lse`` fp32
    [b, h, sq] (``-1e30`` on rows that see no key)."""
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
    out = torch.einsum("bhqk,bhkd->bhqd", p / safe_l, v.float())
    lse = (mx + torch.log(safe_l))[..., 0]
    return out.to(q.dtype), lse


def mha_reference(q, k, v, *, causal=False, segment_ids_q=None,
                  segment_ids_kv=None, scale=None, bias=None):
    """Plain multi-head attention (the JAX ``mha_reference``): fp32 math,
    output in ``q.dtype``; padding rows (segment id < 0) are zero."""
    out, _ = flash_attention_reference(
        q, k, v, causal=causal, segment_ids_q=segment_ids_q,
        segment_ids_kv=segment_ids_kv, scale=scale, bias=bias)
    return out


def _bwd_probs(q, k, lse, causal, segment_ids_q, segment_ids_kv, scale):
    """The backward's fp32 probabilities p = exp(s * scale - lse), zero
    where the mask is false."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = _attention_mask(q.shape[2], k.shape[2], q.device, causal,
                           segment_ids_q, segment_ids_kv)
    if mask is None:
        return torch.exp(s - lse[..., None])
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return torch.where(mask, torch.exp(s - lse[..., None]),
                       torch.zeros_like(s))


def flash_attention_bwd_reference(q, k, v, out, lse, do, *, causal=False,
                                  segment_ids_q=None, segment_ids_kv=None,
                                  scale=None):
    """Plain attention backward — the JAX ``_bwd_math`` operation for
    operation: p from the saved ``lse`` (zero where masked), fp32 math,
    ``(dq, dk, dv)`` in the input dtypes."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    p = _bwd_probs(q, k, lse, causal, segment_ids_q, segment_ids_kv, scale)
    do32 = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v.float())
    delta = (do32 * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, out, lse, do, *, causal=False,
                           segment_ids_q=None, segment_ids_kv=None,
                           scale=None):
    """Plain version of the split's dq kernel with the delta fold (the
    wgmma route's ``flash_dq_sm90``): ``(dq, delta)``, delta = rowsum(do *
    out) fp32 [b, h, sq], computed from the forward's output as the kernel
    computes it for its own rows, then dq = (p * (dp - delta)) k * scale
    in fp32, in q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    delta = (do.float() * out.float()).sum(dim=-1)
    p = _bwd_probs(q, k, lse, causal, segment_ids_q, segment_ids_kv, scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    return dq.to(q.dtype), delta


def flash_bwd_dkdv_reference(q, k, v, lse, delta, do, *, causal=False,
                             segment_ids_q=None, segment_ids_kv=None,
                             scale=None):
    """Plain version of the split's dk/dv kernel: ``(dk, dv)`` from the
    forward's ``lse`` and ``delta`` [b, h, sq] (the dq kernel's, on the
    wgmma route), fp32 math, in k's and v's dtypes."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p = _bwd_probs(q, k, lse, causal, segment_ids_q, segment_ids_kv, scale)
    do32 = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v.float())
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


def _promoted(*tensors):
    """``(tensors, dtype)`` for operands of more than one dtype: the
    tensors in their promotion, the dtype the kernels run them in (exact:
    bf16 and fp16 promote to fp32)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
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


# apex_flash_fwd_sm90(q, k, v, sid_q, sid_kv, out, lse, b, h, sq, sk, d,
#                     causal, scale, dtype, block_m, stream): the wgmma
# route's forward, without ``p_round`` (it takes no mixed operands) and with
# the rows a block
_SM90_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

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


def fwd_block_rows(bh: int, sq: int, kd: int, sms: int) -> int:
    """Query rows a block of the wgmma forward, from the shape: 64 (one
    consumer warpgroup) at kernel head dim 64, where two such blocks share
    an SM and overlap one's prologue and epilogue with the other's loop,
    and wherever ``bh * ceil(sq / 128)`` blocks of 128 rows would not fill
    ``sms`` SMs (the serve prefill's b1 h16 s512 makes 64 of them for the
    H100's 132 SMs, 128 of 64); else 128 (two consumer warpgroups, one
    block an SM)."""
    return 64 if kd == 64 or bh * -(-sq // 128) < sms else 128


def _flash_fwd_cuda(q, k, v, segment_ids_q, segment_ids_kv, causal, scale,
                    block_rows: Optional[int] = None):
    """The forward kernel. ``block_rows`` (the wgmma route only) forces 64
    or 128 query rows a block, for comparing the two at one shape; None
    takes :func:`fwd_block_rows`."""
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
            err = fn(*args, block_rows, _stream(q))
        else:
            fn = _build.function(_build.dtype_target("flash_fwd", code),
                                 "apex_flash_fwd", _FLASH_ARGS)
            err = fn(*args, p_round, _stream(q))
        _build.check(err, what)
        flash_attention.launches += 1
        if sm90:
            flash_attention.wgmma_launches += 1
        return out, lse

    out, lse = with_padded_last_dim(launch, kd, (q, k, v), sliced=(0,))
    return (out.to(out_dtype) if mixed else out), lse


def flash_attention_fwd(q, k, v, segment_ids_q=None, segment_ids_kv=None,
                        causal: bool = False, scale: Optional[float] = None):
    """``(out, lse)`` of the attention forward: the kernel on CUDA,
    :func:`flash_attention_reference` on the CPU."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if check_device_type(q, "flash_attention") == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, segment_ids_q=segment_ids_q,
            segment_ids_kv=segment_ids_kv, scale=scale)
    return _flash_fwd_cuda(q, k, v, segment_ids_q, segment_ids_kv, causal,
                           scale)


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
# ``rounds`` (it takes no mixed operands); apex_flash_bwd_sm90_dq(...,
# sid_kv, dq, out, b, ...) also takes the forward's output (the delta fold)
_SM90_DKDV_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_SM90_DQ_ARGS = _SM90_DKDV_ARGS

# the wgmma route's single pass, apex_flash_bwd_sm90_fused: the single
# pass's arguments without ``rounds``
_SM90_FUSED_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

_TURN_ROWS = 64     # the single pass's query tiles: a turn counter each


def single_pass_turns(b: int, h: int, sq: int, kd: int, sm90: bool) -> int:
    """The int32 turn counters the single-pass backward needs
    (``csrc/turns.cuh``): one a 64-row query tile of each (batch, head),
    times, on ``csrc/flash_bwd.cu``'s route, the kernel's gradient-column
    chunks a block (at most ``kd / 32``, kd the kernel head dim). Each
    tile's dq is summed in a fixed order of its key tiles, so dq is the
    same bits on every run."""
    tiles = b * h * -(-sq // _TURN_ROWS)
    return tiles if sm90 else tiles * (kd // 32)


def single_pass_dq_order(sq: int, sk: int, causal: bool,
                         sm90: bool) -> List[List[int]]:
    """The order in which the single-pass kernels add their dq partials
    (``csrc/turns.cuh``): for each 64-row query tile, the key blocks that
    reach it, first to last. A key block reaches every query tile from the
    first whose last row sees its first key (causal: the end-aligned offset
    ``sk - sq``) to the last, so the blocks that reach a tile are blocks
    0 .. J, and both routes add them in descending order: block j after
    block j + 1, whose first tile under a causal mask is later than j's,
    so that it runs ahead of j when both are resident. Each route's grid
    runs its key blocks in reverse (the wgmma route: 128 keys a block,
    grid (b h, key block); ``csrc/flash_bwd.cu``: 64 keys a block on the
    grid's fast axis), so a block waits only for one the hardware
    dispatched before it."""
    keys = 128 if sm90 else 64
    n_qt, n_kb = -(-sq // _TURN_ROWS), -(-sk // keys)
    order = []
    for qt in range(n_qt):
        blocks = [j for j in range(n_kb)
                  if not causal
                  or max(0, keys * j - (sk - sq)) // _TURN_ROWS <= qt]
        order.append(blocks[::-1])
    return order


def _dq_workspace(q, kd: int, sm90: bool):
    """``(dq_acc, turns)``: the single pass's zeroed fp32 dq accumulator in
    q's shape and its zeroed turn counters, cut from one buffer (one
    zeroing pass for both)."""
    b, h, sq, _ = q.shape
    ws = torch.zeros(q.numel() + single_pass_turns(b, h, sq, kd, sm90),
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
                    causal, scale, split: Optional[bool] = None):
    """The backward kernels. ``split=None`` routes by
    :func:`uses_split_backward`; True or False forces the two-kernel split
    or the single pass (for comparing the two at one shape)."""
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
    if split is None:
        split = uses_split_backward(sq, sk, d, k.element_size(),
                                    v.element_size(), causal)
    # mixed operands: promoted, with the JAX kernels' roundings; each
    # gradient takes its input's dtype
    dtypes = (q.dtype, k.dtype, v.dtype)
    rounds = _mixed_rounds(q, k, do)
    mixed = not q.dtype == k.dtype == v.dtype == do.dtype
    if mixed:
        (q, k, v, do), dtype = _promoted(q, k, v, do)
    else:
        dtype = q.dtype
    # delta = rowsum(do * o) in fp32: outside the kernels as in the JAX
    # package (_flash_bwd_impl), except on the split's wgmma route, whose dq
    # kernel computes it for its own rows (launched first: the delta fold)
    fold = (split and split_route(dtype, dp) == "flash_bwd_sm90"
            and out.dtype == dtype)
    # (out is promoted inside the product: the same exact fp32 products and
    # sum as out.float(), one pass fewer)
    delta = None if fold else (do.float() * out).sum(dim=-1)

    def launch(q, k, v, do, out=None):
        if split:
            dl = delta
            if fold:
                dl = torch.empty((b, h, sq), dtype=torch.float32,
                                 device=q.device)
            args = (q, k, v, do, lse, dl, segment_ids_q, segment_ids_kv,
                    causal, scale, rounds)
            if fold:
                dq = _flash_dq_cuda(*args, out=out)
                return (dq, *_flash_dkdv_cuda(*args))
            dk, dv = _flash_dkdv_cuda(*args)
            return _flash_dq_cuda(*args), dk, dv
        sm90 = sm90_route(dtype, dp)
        dq_acc, turns = _dq_workspace(q, dp, sm90)
        if sm90:
            dk, dv = _flash_bwd_fused_cuda(q, k, v, do, lse, delta,
                                           segment_ids_q, segment_ids_kv,
                                           causal, scale, dq_acc, turns)
            return dq_acc.to(q.dtype), dk, dv
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

    grads = with_padded_last_dim(launch, dp, (q, k, v, do, out) if fold
                                 else (q, k, v, do), sliced=(0, 1, 2))
    if not mixed:
        return grads
    return tuple(g.to(dt) for g, dt in zip(grads, dtypes))


def _flash_bwd_fused_cuda(q, k, v, do, lse, delta, sid_q, sid_kv, causal,
                          scale, dq_acc, turns=None):
    """The wgmma route's single pass (``flash_bwd_fused_sm90``) on operands
    ``_flash_bwd_cuda`` checked: ``(dk, dv)``, and dq times ``scale`` added
    in a fixed order into ``dq_acc`` (fp32, q's shape; the caller zeroes
    it). ``turns``: the zeroed int32 turn counters
    (:func:`single_pass_turns`), allocated here when None. ``delta`` =
    rowsum(do * out) fp32 [b, h, sq], given."""
    b, h, sq, d = q.shape
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
                    int(bool(causal)), float(scale), code, _stream(q)),
                 "flash_attention_bwd single-pass kernel")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.wgmma_launches += 1
    return dk, dv


def _split_operands(q, k, v, do, lse, delta, sid_q, sid_kv, causal, scale,
                    rounds):
    """``(route, operands, tail)`` of a split kernel's C call: the route
    (:func:`split_route`), the eight input pointers, and the sizes, flags
    and stream after the output pointers."""
    b, h, sq, d = q.shape
    route = split_route(q.dtype, d)
    tail = (b, h, sq, k.shape[2], d, int(bool(causal)), float(scale),
            DTYPE_CODES[q.dtype])
    tail += (_stream(q),) if route == "flash_bwd_sm90" else (rounds,
                                                             _stream(q))
    return route, (_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
                   _ptr(delta), _ptr(sid_q), _ptr(sid_kv)), tail


def _flash_dkdv_cuda(q, k, v, do, lse, delta, sid_q, sid_kv, causal, scale,
                     rounds):
    """The split's dk/dv kernel on operands ``_flash_bwd_cuda`` checked and
    promoted; ``delta`` = rowsum(do * out) fp32 [b, h, sq]."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    route, operands, tail = _split_operands(q, k, v, do, lse, delta, sid_q,
                                            sid_kv, causal, scale, rounds)
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
    return dk, dv


def _flash_dq_cuda(q, k, v, do, lse, delta, sid_q, sid_kv, causal, scale,
                   rounds, out=None):
    """The split's dq kernel, as :func:`_flash_dkdv_cuda`. With ``out``
    (the forward's output, q's dtype; the wgmma route only) the kernel
    computes delta itself and writes it into ``delta``."""
    dq = torch.empty_like(q)
    route, operands, tail = _split_operands(q, k, v, do, lse, delta, sid_q,
                                            sid_kv, causal, scale, rounds)
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
                        scale: Optional[float] = None):
    """``(dq, dk, dv)`` of the attention from the forward's ``out`` and
    ``lse``: on CUDA the single-pass kernel, or past the JAX package's gate
    (:func:`uses_split_backward`) the dk/dv kernel then the dq kernel; on
    the CPU :func:`flash_attention_bwd_reference`.
    ``flash_attention_bwd.launches`` counts single-pass launches
    (``.wgmma_launches`` those on the wgmma route), ``.dkdv_launches`` and
    ``.dq_launches`` the split's."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if check_device_type(q, "flash_attention_bwd") == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=causal,
            segment_ids_q=segment_ids_q, segment_ids_kv=segment_ids_kv,
            scale=scale)
    return _flash_bwd_cuda(q, k, v, out, lse, do, segment_ids_q,
                           segment_ids_kv, causal, scale)


flash_attention_bwd.launches = 0
flash_attention_bwd.wgmma_launches = 0
flash_attention_bwd.dkdv_launches = 0
flash_attention_bwd.dq_launches = 0
flash_attention_bwd.wgmma_dkdv_launches = 0
flash_attention_bwd.wgmma_dq_launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Forward kernel + backward kernel as one differentiable op. Saves
    ``(q, k, v, out, lse)`` and the segment ids; segment ids get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids_q, segment_ids_kv, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, segment_ids_q,
                                       segment_ids_kv, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids_q,
                              segment_ids_kv)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, sid_q, sid_kv = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         sid_q, sid_kv, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None, None, None


class BiasedAttentionFunction(torch.autograd.Function):
    """The plain attention under an additive bias (the CPU route): the
    gradients of q, k and v are autograd's through
    :func:`mha_reference`, and the bias's is exactly zero in its own shape
    (the JAX op's ``dbias = zeros_like(bias)``, ``_fa_bwd``: the bias is
    an additive mask, non-differentiable by contract)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, segment_ids_q, segment_ids_kv, causal,
                scale):
        ctx.save_for_backward(q, k, v, bias, segment_ids_q, segment_ids_kv)
        ctx.causal, ctx.scale = causal, scale
        return mha_reference(q, k, v, causal=causal,
                             segment_ids_q=segment_ids_q,
                             segment_ids_kv=segment_ids_kv, scale=scale,
                             bias=bias)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, sid_q, sid_kv = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = mha_reference(*qkv, causal=ctx.causal,
                                segment_ids_q=sid_q, segment_ids_kv=sid_kv,
                                scale=ctx.scale, bias=bias.detach())
            dq, dk, dv = torch.autograd.grad(out, qkv, do)
        dbias = torch.zeros_like(bias) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias, None, None, None, None


def flash_attention(q, k, v, segment_ids_q=None, segment_ids_kv=None,
                    causal: bool = False, scale: Optional[float] = None,
                    bias=None, dropout_rate: float = 0.0, dropout_seed=None):
    """Fused attention, differentiable in ``q``, ``k`` and ``v``. Returns
    [b, h, sq, d] in ``q.dtype``.

    ``segment_ids_*``: tokens attend only within equal non-negative ids;
    negative ids are padding and give zero rows. ``bias`` ([b|1, h|1, sq,
    sk], added to the scaled scores) runs through the plain version on the
    CPU (:class:`BiasedAttentionFunction`: its gradient is exactly zero,
    as in the JAX package) and is not supported by the kernels yet;
    ``dropout_rate > 0`` is not ported yet."""
    if dropout_rate:
        raise NotImplementedError("attention dropout is not ported yet")
    if bias is not None:
        if check_device_type(q, "flash_attention") == "cuda":
            raise NotImplementedError("flash_attention: the additive bias "
                                      "is not in the CUDA kernels yet")
        b, h, sq, sk = q.shape[0], q.shape[1], q.shape[2], k.shape[2]
        if (bias.dim() != 4 or bias.shape[0] not in (1, b)
                or bias.shape[1] not in (1, h)
                or tuple(bias.shape[2:]) != (sq, sk)):
            raise ValueError(f"bias must broadcast to [{b}, {h}, {sq}, "
                             f"{sk}], got {tuple(bias.shape)}")
        return BiasedAttentionFunction.apply(q, k, v, bias, segment_ids_q,
                                             segment_ids_kv, bool(causal),
                                             scale)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return FlashAttentionFunction.apply(q, k, v, segment_ids_q,
                                        segment_ids_kv, bool(causal), scale)


flash_attention.launches = 0
flash_attention.wgmma_launches = 0


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
