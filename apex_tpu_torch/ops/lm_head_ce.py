"""Fused LM head + cross entropy: CUDA kernels beside their plain PyTorch
versions (``apex_tpu/ops/lm_head_ce.py``).

The per-token loss of ``x @ embedding^T`` without the ``[tokens, V]``
logits ever reaching device memory on the card:

- :func:`lm_head_ce_fwd` — per-token row max ``m``, sum-exp ``l``, target
  logit and (label smoothing) raw-logit row sum. On CUDA it launches
  ``csrc/lm_head_ce.cu``'s forward, which replaces the Pallas
  ``_fwd_kernel`` (``apex_tpu/ops/lm_head_ce.py:162``), and combines the
  kernel's per-vocab-chunk partials in torch as the JAX package combines
  its own (``:266-271``); on the CPU it is :func:`lm_head_ce_fwd_reference`.
- :func:`lm_head_ce_bwd` — ``(dx, dE)`` from the saved ``m``, ``l`` and
  the upstream gradient. On CUDA one call launches the source's two
  backward passes (dE rows, then dx rows), which together replace the
  Pallas ``_bwd_kernel`` (``:198``); on the CPU it is
  :func:`lm_head_ce_bwd_reference`.
- :func:`fused_lm_head_cross_entropy` — the differentiable op
  (:class:`FusedLMHeadCEFunction`) at tensor-parallel world size 1.

Numerics (as the JAX package): logits with the operands' dtype (bf16,
fp16 or fp32 — fp32 through the SIMT product of ``csrc/frag.cuh``, for O0)
and fp32 accumulation, never rounded; fp32 reductions; the gradient tile
``(softmax - target) * dloss`` rounded to the activation dtype before both
products; dE accumulated in fp32 and cast to the embedding's dtype. dx is
summed over the whole vocabulary in fp32 (the JAX kernel adds per-block
partials). The plain versions compute the logits in fp32 from upcast
operands, which is what the JAX package's interpret mode does.

Any hidden size: the kernels hold at most ``kc`` columns of a tile in
shared memory (:func:`hidden_chunks`), so the wrapper zero-pads h in x and
the embedding to ``nch * kc`` (the zero columns change no logit and get a
zero gradient, sliced off) and the kernels loop over the chunks.

``lm_head_ce_fwd.launches`` and ``lm_head_ce_bwd.launches`` count kernel
calls (the backward's one call launches its two passes).
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

_VOCAB_PER_BLOCK = 1024        # vocab rows per forward block (VT_FWD * TV)
_CHUNK = 64                    # kc is a multiple of the 8 warps' 8 columns
# the most hidden columns of a 32-row tile the kernels hold in shared memory
_MAX_CHUNK = {torch.bfloat16: 1024, torch.float16: 1024, torch.float32: 512}


def hidden_chunks(h: int, dtype: torch.dtype):
    """``(hp, kc)``: the kernels run hidden size ``h`` zero-padded to
    ``hp = nch * kc`` in ``nch`` chunks of ``kc`` columns (a multiple of
    64, at most 1024 for 16-bit operands and 512 for fp32, the fewest
    chunks and then the least padding)."""
    nch = -(-h // _MAX_CHUNK[dtype])
    kc = -(-(-(-h // nch)) // _CHUNK) * _CHUNK
    return nch * kc, kc


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

# apex_lm_head_ce_fwd(x, e, tgt, m_part, l_part, p_part, s_part, n, V, hp,
#                     kc, dtype, stream)
_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# apex_lm_head_ce_bwd(x, e, tgt, m, l, dl, de, dx, n, V, hp, kc, ls,
#                     ls_over_v, dtype, stream)
_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


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


def _ce_fwd_cuda(x2d, e, tgt, with_ssum):
    what = "lm_head_ce_fwd kernel"
    _check_operands(what, x2d, e, tgt)
    n, h = x2d.shape
    V = e.shape[0]
    hp, kc = hidden_chunks(h, x2d.dtype)
    n_vb = -(-V // _VOCAB_PER_BLOCK)

    def launch(x2d, e):
        parts = torch.empty((4 if with_ssum else 3, n_vb, n),
                            dtype=torch.float32, device=x2d.device)
        fn = _build.function(_build.dtype_target(
            "lm_head_ce", DTYPE_CODES[x2d.dtype]), "apex_lm_head_ce_fwd",
            _FWD_ARGS)
        err = fn(_ptr(x2d), _ptr(e), _ptr(tgt), _ptr(parts[0]),
                 _ptr(parts[1]), _ptr(parts[2]),
                 _ptr(parts[3]) if with_ssum else None, n, V, hp, kc,
                 DTYPE_CODES[x2d.dtype], _stream(x2d))
        _build.check(err, what)
        lm_head_ce_fwd.launches += 1
        return (parts,)

    parts, = with_padded_last_dim(launch, hp, (x2d, e))
    m_p, l_p, p_p = parts[0], parts[1], parts[2]
    # combine the per-block online-softmax partials (tiny: [n_vb, n])
    m = m_p.amax(dim=0)
    l = (l_p * torch.exp(m_p - m)).sum(dim=0)
    ssum = parts[3].sum(dim=0) if with_ssum else None
    return m, l, p_p.sum(dim=0), ssum


def lm_head_ce_fwd(x2d, e, tgt, with_ssum: bool = False):
    """``(m, l, pred, ssum | None)`` per token: the kernel on CUDA,
    :func:`lm_head_ce_fwd_reference` on the CPU."""
    if check_device_type(x2d, "lm_head_ce_fwd") == "cpu":
        return lm_head_ce_fwd_reference(x2d, e, tgt, with_ssum)
    return _ce_fwd_cuda(x2d, e, tgt, with_ssum)


lm_head_ce_fwd.launches = 0


def _ce_bwd_cuda(x2d, e, tgt, m, l, dloss, label_smoothing):
    what = "lm_head_ce_bwd kernel"
    _check_operands(what, x2d, e, tgt)
    n, h = x2d.shape
    V = e.shape[0]
    _require(m.shape == (n,) and l.shape == (n,) and dloss.shape == (n,),
             what, "m, l and dloss must be [n]")
    _check_cuda_operands(what, (("m", m), ("l", l), ("dloss", dloss)),
                         torch.float32, x2d.device)
    hp, kc = hidden_chunks(h, x2d.dtype)
    ls = float(label_smoothing)

    def launch(x2d, e):
        de = torch.empty_like(e)
        dx = torch.empty_like(x2d)
        fn = _build.function(_build.dtype_target(
            "lm_head_ce", DTYPE_CODES[x2d.dtype]), "apex_lm_head_ce_bwd",
            _BWD_ARGS)
        err = fn(_ptr(x2d), _ptr(e), _ptr(tgt), _ptr(m), _ptr(l),
                 _ptr(dloss), _ptr(de), _ptr(dx), n, V, hp, kc, ls, ls / V,
                 DTYPE_CODES[x2d.dtype], _stream(x2d))
        _build.check(err, what)
        lm_head_ce_bwd.launches += 1
        return dx, de

    return with_padded_last_dim(launch, hp, (x2d, e), sliced=(0, 1))


def lm_head_ce_bwd(x2d, e, tgt, m, l, dloss, label_smoothing: float = 0.0):
    """``(dx, dE)``: the kernel's two passes on CUDA,
    :func:`lm_head_ce_bwd_reference` on the CPU."""
    if check_device_type(x2d, "lm_head_ce_bwd") == "cpu":
        return lm_head_ce_bwd_reference(x2d, e, tgt, m, l, dloss,
                                        label_smoothing)
    return _ce_bwd_cuda(x2d, e, tgt, m, l, dloss, label_smoothing)


lm_head_ce_bwd.launches = 0


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
