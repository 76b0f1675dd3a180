"""Fused LM head + cross entropy: CUDA kernels beside their plain PyTorch
versions (``apex_tpu/ops/lm_head_ce.py``).

The per-token loss of ``x @ embedding^T`` without the ``[tokens, V]``
logits ever reaching device memory in the forward:

- :func:`lm_head_ce_fwd` — per-token row max ``m``, sum-exp ``l``, target
  logit and (label smoothing) raw-logit row sum. On CUDA it launches the
  forward kernel, which replaces the Pallas ``_fwd_kernel``
  (``apex_tpu/ops/lm_head_ce.py:162``), and combines the kernel's
  per-vocab-slice partials in torch as the JAX package combines its own
  (``:266-271``); on the CPU it is :func:`lm_head_ce_fwd_reference`.
- :func:`lm_head_ce_bwd` — ``(dx, dE)`` from the saved ``m``, ``l`` and
  the upstream gradient. On CUDA one call launches the backward kernels,
  which together replace the Pallas ``_bwd_kernel`` (``:198``); on the CPU
  it is :func:`lm_head_ce_bwd_reference`.
- :func:`fused_lm_head_cross_entropy` — the differentiable op
  (:class:`FusedLMHeadCEFunction`) at tensor-parallel world size 1.

Two routes by operand dtype:

- bf16 and fp16: ``csrc/lm_head_ce_sm90.cu``, wgmma/TMA products on the
  shared core of ``csrc/wgmma_gemm.cuh``. The forward folds 128 x 128
  logit tiles into per-token partials over :func:`vocab_slices` slices of
  the vocabulary. The backward runs three products per chunk of
  :func:`bwd_chunk_tokens` tokens: the logits, whose epilogue writes the
  gradient tile g to a workspace ``[T_c, V]`` (at most
  :data:`G_WORKSPACE_BYTES`) in the activation dtype; ``dx = g E``; and
  ``dE += g^T x`` into an fp32 accumulator. The hidden size is
  zero-padded to a multiple of 8 (:func:`wgmma_hidden`: TMA's 16-byte row
  strides; the zero columns change no logit and get a zero gradient,
  sliced off).
- fp32 (O0): ``csrc/lm_head_ce.cu``, on the register-blocked FFMA core of
  ``csrc/simt_f32.cuh`` (exact fp32 products: wgmma has no exact fp32
  product, and TF32 would round the operands of the mode users compare
  against). Each call transposes x and E once into workspaces (the
  core takes operands k-row by k-row). The forward folds 128 x 128 logit
  tiles into per-token partials over :func:`f32_vocab_slices` slices; the
  backward runs three products a chunk of :func:`f32_chunk_tokens`
  tokens: the logits, whose epilogue writes g in fp32 in two layouts (G
  and G^T, together at most :data:`F32_WORKSPACE_BYTES`); ``dx = G E``;
  and ``dE += G^T x``, in place in fp32 (E's dtype). The hidden size is
  zero-padded to a multiple of 4 (:func:`f32_hidden`: 16-byte rows).

Numerics (as the JAX package): logits with the operands' dtype and fp32
accumulation, never rounded; fp32 reductions; the gradient tile
``(softmax - target) * dloss`` rounded to the activation dtype before both
products; dE accumulated in fp32 and cast to the embedding's dtype once. dx
is summed over the whole vocabulary in fp32 (the JAX kernel adds per-block
partials). The plain versions compute the logits in fp32 from upcast
operands, which is what the JAX package's interpret mode does.

``lm_head_ce_fwd.launches`` and ``lm_head_ce_bwd.launches`` count kernel
calls on either route (one a call; the backward's call launches its
products chunk by chunk), ``.f32_launches`` those of the fp32 route.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from apex_tpu_torch._compat import check_device_type
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._pad import with_padded_last_dim
from apex_tpu_torch.ops.flash_attention import (DTYPE_CODES,
                                                _check_cuda_operands, _ptr,
                                                _require, _stream)

_SM90_DTYPES = (torch.bfloat16, torch.float16)
_TILE = 128                    # both routes' tile rows and columns
# the wgmma backward's gradient workspace G [T_c, V] holds at most this
# many bytes (about the [n_vb, n, h] dx partials the JAX kernel leaves in
# HBM at its block of 2048 vocab rows)
G_WORKSPACE_BYTES = 256 << 20
# the fp32 backward's G [T_c, V] and G^T [V, T_c] together hold at most
# this many bytes: 4096 tokens a chunk at V 32768, so that dx's grid (128
# token rows x 128 hidden columns a block) fills the H100's 132 SMs twice
# at h 1024; the library composition it stands beside keeps 1 GB of fp32
# logits and 1 GB of their gradient at that shape
F32_WORKSPACE_BYTES = 1 << 30


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def f32_hidden(h: int) -> int:
    """The hidden size the fp32 route runs ``h`` at: rounded up to 4, for
    the 16-byte copies of its rows (the kernels take any such h)."""
    return _round_up(h, 4)


def f32_vocab_slices(n: int, V: int, sms: int) -> int:
    """Vocabulary slices of the fp32 forward: enough 128-token x slice
    blocks for about two a SM (the core runs two blocks an SM), at least
    1 and no more than the vocabulary's 128-row tiles."""
    tiles_m, tiles_v = -(-n // _TILE), -(-V // _TILE)
    return max(1, min(tiles_v, round(2 * sms / tiles_m)))


def f32_chunk_tokens(n: int, V: int) -> int:
    """Tokens a chunk of the fp32 backward: the most multiples of 128
    whose fp32 G and G^T (``2 x T_c x round4(V)`` floats) fit
    :data:`F32_WORKSPACE_BYTES` (at least 128), and no more than ``n``
    needs."""
    row = 2 * _round_up(V, 4) * 4
    chunk = max(_TILE, F32_WORKSPACE_BYTES // row // _TILE * _TILE)
    return min(chunk, _round_up(n, _TILE))


def wgmma_hidden(h: int) -> int:
    """The hidden size the bf16/fp16 (wgmma) route runs ``h`` at: rounded
    up to 8, for TMA's 16-byte row strides (the kernels stream h in
    K-stages, so it takes no chunks)."""
    return _round_up(h, 8)


def bwd_chunk_tokens(n: int, V: int) -> int:
    """Tokens per chunk of the wgmma backward: the most multiples of 128
    whose 16-bit gradient workspace ``[T_c, V rounded up to 8]`` fits
    :data:`G_WORKSPACE_BYTES` (at least 128), and no more than ``n``
    needs."""
    row = _round_up(V, 8) * 2
    chunk = max(_TILE, G_WORKSPACE_BYTES // row // _TILE * _TILE)
    return min(chunk, _round_up(n, _TILE))


def vocab_slices(n: int, V: int, sms: int) -> int:
    """Vocabulary slices of the wgmma forward: enough 128-token x slice
    blocks for about two waves over ``sms`` SMs, between 1 and 8 and no
    more than the vocabulary's 128-row tiles."""
    tiles_m, tiles_v = -(-n // _TILE), -(-V // _TILE)
    return max(1, min(8, tiles_v, round(2 * sms / tiles_m)))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _logits(x2d, e):
    return x2d.float() @ e.float().t()


def _target_weights(tgt, V, label_smoothing, device):
    """[n, V] fp32: one-hot of the in-range targets, smoothed."""
    cols = torch.arange(V, device=device)
    hit = (tgt.long()[:, None] == cols[None, :]).float()
    if label_smoothing > 0.0:
        return (1.0 - label_smoothing) * hit + label_smoothing / V
    return hit


def lm_head_ce_fwd_reference(x2d, e, tgt, with_ssum: bool = False):
    """Plain per-token statistics ``(m, l, pred, ssum | None)`` of the fp32
    logits ``x2d @ e^T``: row max, sum of ``exp(logit - m)``, the target's
    logit (0 for an out-of-range target) and the row sum."""
    s = _logits(x2d, e)
    V = e.shape[0]
    m = s.amax(dim=-1)
    l = torch.exp(s - m[:, None]).sum(dim=-1)
    t = tgt.long()
    in_range = (t >= 0) & (t < V)
    pred = torch.where(in_range,
                       s.gather(1, t.clamp(0, V - 1)[:, None])[:, 0],
                       torch.zeros_like(m))
    ssum = s.sum(dim=-1) if with_ssum else None
    return m, l, pred, ssum


def lm_head_ce_bwd_reference(x2d, e, tgt, m, l, dloss,
                             label_smoothing: float = 0.0):
    """Plain backward: ``g = ((softmax - target) * dloss)`` rounded to
    ``x2d.dtype``, then ``dE = g^T x`` and ``dx = g e`` in fp32, cast to
    ``e.dtype`` and ``x2d.dtype``."""
    s = _logits(x2d, e)
    p = torch.exp(s - m[:, None]) / l[:, None]
    target = _target_weights(tgt, e.shape[0], label_smoothing, x2d.device)
    g = ((p - target) * dloss.float()[:, None]).to(x2d.dtype).float()
    de = (g.t() @ x2d.float()).to(e.dtype)
    dx = (g @ e.float()).to(x2d.dtype)
    return dx, de


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

# apex_lm_head_ce_fwd(x, e, tgt, xt, et, m_part, l_part, p_part, s_part, n,
#                     V, hp, n_slices, dtype, stream)  (fp32)
_FWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# apex_lm_head_ce_sm90_fwd(x, e, tgt, m_part, l_part, p_part, s_part, n, V,
#                          hp, n_slices, dtype, stream)  (bf16, fp16)
_SM90_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]
# apex_lm_head_ce_bwd(x, e, tgt, m, l, dl, xt, et, g, gt, de, dx, n, V, hp,
#                     chunk, ls, ls_over_v, dtype, stream)  (fp32)
_BWD_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# apex_lm_head_ce_sm90_bwd(x, e, tgt, m, l, dl, g, de_acc, de, dx, n, V, hp,
#                          vs, chunk, ls, ls_over_v, dtype, stream)
_SM90_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# apex_wgmma_probe(a, b, c, M, N, K, a_mn, b_mn, dtype, stream)
_PROBE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _check_operands(what, x2d, e, tgt):
    _require(x2d.dim() == 2 and e.dim() == 2 and x2d.shape[1] == e.shape[1],
             what, f"x {tuple(x2d.shape)} / embedding {tuple(e.shape)} must "
             "be [n, h] and [V, h]")
    _require(x2d.dtype in DTYPE_CODES, what, "takes bfloat16, float16 or "
             f"float32 operands, got {x2d.dtype}")
    _check_cuda_operands(what, (("x", x2d), ("embedding", e)), x2d.dtype,
                         x2d.device)
    _require(tgt.shape == (x2d.shape[0],), what, "targets must be [n]")
    _check_cuda_operands(what, (("targets", tgt),), torch.int32, x2d.device)


def _f32_transposes(n, V, hp, device):
    """The fp32 route's workspaces for x^T [hp, round4(n)] and E^T [hp,
    round4(V)] (the kernels write every element, zeros past n and V)."""
    return (torch.empty((hp, _round_up(n, 4)), dtype=torch.float32,
                        device=device),
            torch.empty((hp, _round_up(V, 4)), dtype=torch.float32,
                        device=device))


def _source(x2d):
    """The build target of the operands' route: ``lm_head_ce_sm90`` for
    bf16 and fp16, ``lm_head_ce`` for fp32."""
    name = "lm_head_ce_sm90" if x2d.dtype in _SM90_DTYPES else "lm_head_ce"
    return _build.dtype_target(name, DTYPE_CODES[x2d.dtype])


def _ce_fwd_cuda(x2d, e, tgt, with_ssum):
    what = "lm_head_ce_fwd kernel"
    _check_operands(what, x2d, e, tgt)
    n, h = x2d.shape
    V = e.shape[0]
    sm90 = x2d.dtype in _SM90_DTYPES
    sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
    hp = wgmma_hidden(h) if sm90 else f32_hidden(h)
    n_part = vocab_slices(n, V, sms) if sm90 else f32_vocab_slices(n, V, sms)

    def launch(x2d, e):
        parts = torch.empty((4 if with_ssum else 3, n_part, n),
                            dtype=torch.float32, device=x2d.device)
        outs = (_ptr(parts[0]), _ptr(parts[1]), _ptr(parts[2]),
                _ptr(parts[3]) if with_ssum else None)
        code = DTYPE_CODES[x2d.dtype]
        if sm90:
            fn = _build.function(_source(x2d), "apex_lm_head_ce_sm90_fwd",
                                 _SM90_FWD_ARGS)
            err = fn(_ptr(x2d), _ptr(e), _ptr(tgt), *outs, n, V, hp, n_part,
                     code, _stream(x2d))
        else:
            xt, et = _f32_transposes(n, V, hp, x2d.device)
            fn = _build.function(_source(x2d), "apex_lm_head_ce_fwd",
                                 _FWD_ARGS)
            err = fn(_ptr(x2d), _ptr(e), _ptr(tgt), _ptr(xt), _ptr(et),
                     *outs, n, V, hp, n_part, code, _stream(x2d))
        _build.check(err, what)
        lm_head_ce_fwd.launches += 1
        if not sm90:
            lm_head_ce_fwd.f32_launches += 1
        return (parts,)

    parts, = with_padded_last_dim(launch, hp, (x2d, e))
    return combine_partials(parts)


def combine_partials(parts):
    """``(m, l, pred, ssum | None)`` from the forward kernels' per-slice
    online-softmax partials ``parts`` [3 or 4, n_slices, n] (m, l, pred,
    and ssum under label smoothing; tiny), as the JAX package combines its
    own (``:266-271``). A slice that saw no vocabulary row holds m = -1e30,
    l = 0 and adds nothing."""
    m_p, l_p, p_p = parts[0], parts[1], parts[2]
    m = m_p.amax(dim=0)
    l = (l_p * torch.exp(m_p - m)).sum(dim=0)
    ssum = parts[3].sum(dim=0) if parts.shape[0] == 4 else None
    return m, l, p_p.sum(dim=0), ssum


def lm_head_ce_fwd(x2d, e, tgt, with_ssum: bool = False):
    """``(m, l, pred, ssum | None)`` per token: the kernel on CUDA,
    :func:`lm_head_ce_fwd_reference` on the CPU."""
    if check_device_type(x2d, "lm_head_ce_fwd") == "cpu":
        return lm_head_ce_fwd_reference(x2d, e, tgt, with_ssum)
    return _ce_fwd_cuda(x2d, e, tgt, with_ssum)


lm_head_ce_fwd.launches = 0
lm_head_ce_fwd.f32_launches = 0


def _ce_bwd_cuda(x2d, e, tgt, m, l, dloss, label_smoothing):
    what = "lm_head_ce_bwd kernel"
    _check_operands(what, x2d, e, tgt)
    n, h = x2d.shape
    V = e.shape[0]
    _require(m.shape == (n,) and l.shape == (n,) and dloss.shape == (n,),
             what, "m, l and dloss must be [n]")
    _check_cuda_operands(what, (("m", m), ("l", l), ("dloss", dloss)),
                         torch.float32, x2d.device)
    sm90 = x2d.dtype in _SM90_DTYPES
    hp = wgmma_hidden(h) if sm90 else f32_hidden(h)
    ls = float(label_smoothing)
    code = DTYPE_CODES[x2d.dtype]

    def launch_sm90(x2d, e):
        vs = _round_up(V, 8)
        chunk = bwd_chunk_tokens(n, V)
        g = torch.empty((chunk, vs), dtype=x2d.dtype, device=x2d.device)
        de_acc = (torch.empty((V, hp), dtype=torch.float32,
                              device=x2d.device) if n > chunk else None)
        de = torch.empty_like(e)
        dx = torch.empty_like(x2d)
        fn = _build.function(_source(x2d), "apex_lm_head_ce_sm90_bwd",
                             _SM90_BWD_ARGS)
        err = fn(_ptr(x2d), _ptr(e), _ptr(tgt), _ptr(m), _ptr(l),
                 _ptr(dloss), _ptr(g), _ptr(de_acc), _ptr(de), _ptr(dx), n,
                 V, hp, vs, chunk, ls, ls / V, code, _stream(x2d))
        _build.check(err, what)
        lm_head_ce_bwd.launches += 1
        return dx, de

    def launch_f32(x2d, e):
        chunk = f32_chunk_tokens(n, V)
        vp = _round_up(V, 4)
        xt, et = _f32_transposes(n, V, hp, x2d.device)
        g = torch.empty((chunk, vp), dtype=torch.float32, device=x2d.device)
        gt = torch.empty((vp, chunk), dtype=torch.float32,
                         device=x2d.device)
        de = torch.empty_like(e)
        dx = torch.empty_like(x2d)
        fn = _build.function(_source(x2d), "apex_lm_head_ce_bwd", _BWD_ARGS)
        err = fn(_ptr(x2d), _ptr(e), _ptr(tgt), _ptr(m), _ptr(l),
                 _ptr(dloss), _ptr(xt), _ptr(et), _ptr(g), _ptr(gt),
                 _ptr(de), _ptr(dx), n, V, hp, chunk, ls, ls / V, code,
                 _stream(x2d))
        _build.check(err, what)
        lm_head_ce_bwd.launches += 1
        lm_head_ce_bwd.f32_launches += 1
        return dx, de

    return with_padded_last_dim(launch_sm90 if sm90 else launch_f32, hp,
                                (x2d, e), sliced=(0, 1))


def lm_head_ce_bwd(x2d, e, tgt, m, l, dloss, label_smoothing: float = 0.0):
    """``(dx, dE)``: the backward kernels on CUDA,
    :func:`lm_head_ce_bwd_reference` on the CPU."""
    if check_device_type(x2d, "lm_head_ce_bwd") == "cpu":
        return lm_head_ce_bwd_reference(x2d, e, tgt, m, l, dloss,
                                        label_smoothing)
    return _ce_bwd_cuda(x2d, e, tgt, m, l, dloss, label_smoothing)


lm_head_ce_bwd.launches = 0
lm_head_ce_bwd.f32_launches = 0


def wgmma_probe(a, b, a_mn: bool, b_mn: bool):
    """The wgmma core of the 16-bit route alone, for the card tests of its
    operand layouts: ``A B`` in fp32, with ``a`` [M, K] (``a_mn`` False) or
    [K, M] (True) and ``b`` [N, K] (``b_mn`` False) or [K, N] (True), one
    bf16 or fp16 dtype, every dim a multiple of 8."""
    what = "wgmma probe"
    _require(a.dtype in _SM90_DTYPES, what, f"takes bf16 or fp16, got "
             f"{a.dtype}")
    _check_cuda_operands(what, (("a", a), ("b", b)), a.dtype, a.device)
    M, K = (a.shape[1], a.shape[0]) if a_mn else a.shape
    N = b.shape[1] if b_mn else b.shape[0]
    _require((b.shape[0] if b_mn else b.shape[1]) == K, what,
             "a and b differ in K")
    c = torch.empty((M, N), dtype=torch.float32, device=a.device)
    fn = _build.function(_build.dtype_target(
        "lm_head_ce_sm90", DTYPE_CODES[a.dtype]), "apex_wgmma_probe",
        _PROBE_ARGS)
    _build.check(fn(_ptr(a), _ptr(b), _ptr(c), M, N, K, int(a_mn),
                    int(b_mn), DTYPE_CODES[a.dtype], _stream(a)), what)
    return c


def _loss_from_stats(m, l, pred, ssum, V, label_smoothing):
    loss = torch.log(l) + m - pred
    if label_smoothing > 0.0:
        mean_logp = ssum / V - m - torch.log(l)
        loss = (1.0 - label_smoothing) * loss - label_smoothing * mean_logp
    return loss


class FusedLMHeadCEFunction(torch.autograd.Function):
    """Forward kernel + backward kernel as one differentiable op over
    ``x2d`` [n, h] and the embedding [V, h]. Saves ``x``, the embedding in
    ``x``'s dtype, the targets and the combined ``m``, ``l``."""

    @staticmethod
    def forward(ctx, x2d, embedding, tgt, label_smoothing):
        ec = embedding.to(x2d.dtype)
        m, l, pred, ssum = lm_head_ce_fwd(x2d, ec, tgt, label_smoothing > 0.0)
        ctx.save_for_backward(x2d, ec, tgt, m, l)
        ctx.label_smoothing = label_smoothing
        ctx.e_dtype = embedding.dtype
        return _loss_from_stats(m, l, pred, ssum, ec.shape[0],
                                label_smoothing)

    @staticmethod
    def backward(ctx, dloss):
        x2d, ec, tgt, m, l = ctx.saved_tensors
        dx, de = lm_head_ce_bwd(x2d, ec, tgt, m, l,
                                dloss.float().contiguous(),
                                ctx.label_smoothing)
        return dx, de.to(ctx.e_dtype), None, None


def fused_lm_head_cross_entropy(x, embedding, targets,
                                label_smoothing: float = 0.0,
                                axis_name: Optional[str] = None):
    """Per-token cross entropy of ``x @ embedding^T``, fp32, with ``x``'s
    leading shape; differentiable in ``x`` and ``embedding``.

    ``x``: ``[..., h]`` activations; ``embedding``: the tied ``[V, h]``
    table; ``targets``: int ``[...]`` vocab ids (an id outside ``[0, V)``
    matches no row). ``axis_name`` names a vocab-parallel axis: only world
    size 1 is ported, and a larger initialised ``torch.distributed`` world
    raises."""
    if (axis_name is not None and torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError("fused_lm_head_cross_entropy: vocab "
                                  "parallelism (world > 1) is not ported "
                                  "yet")
    if not 0.0 <= label_smoothing < 1.0:
        raise ValueError(f"label_smoothing must be in [0, 1), got "
                         f"{label_smoothing}")
    lead = x.shape[:-1]
    x2d = x.reshape(math.prod(lead), x.shape[-1])
    tgt = targets.reshape(-1).to(torch.int32)
    loss = FusedLMHeadCEFunction.apply(x2d, embedding, tgt,
                                       float(label_smoothing))
    return loss.reshape(lead)


def lm_head_cross_entropy_reference(x, embedding, targets,
                                    label_smoothing: float = 0.0):
    """The plain, autograd-differentiated composition — fp32 logits, then
    the smoothed cross entropy — with ``x``'s leading shape."""
    lead = x.shape[:-1]
    x2d = x.reshape(math.prod(lead), x.shape[-1])
    ec = embedding.to(x.dtype)
    m, l, pred, ssum = lm_head_ce_fwd_reference(
        x2d, ec, targets.reshape(-1), label_smoothing > 0.0)
    loss = _loss_from_stats(m, l, pred, ssum, ec.shape[0], label_smoothing)
    return loss.reshape(lead)
