"""Fused softmax cross entropy with label smoothing: Triton kernels beside
the plain PyTorch twin.

Port of ``apex_tpu/ops/fused_ce.py`` (the contrib xentropy of apex). Per
example, with smoothing ``s`` over ``V`` classes::

    loss = (1 - s) * nll(target) + s * mean_v(nll(v))

in fp32; the gradient is ``(softmax - smoothed_target) * dloss`` in the
logits' dtype; rows whose label is ``padding_idx`` get zero loss and zero
gradient.

- :func:`softmax_cross_entropy_reference` — the plain twin, a
  ``torch.autograd.Function`` over the JAX ``_xent_fwd``/``_xent_bwd`` math
  (``apex_tpu/ops/fused_ce.py:69-101``), on any device.
- :func:`softmax_cross_entropy_with_smoothing` — on CUDA the two kernels,
  on the CPU the twin. The JAX package resolves explicit blocks > tuned
  cache > twin; here the tensor's device decides, and the tuner's knobs
  (``block_t``, ``block_v``, ``interpret``, ``autotune``) raise
  ``NotImplementedError`` until the tuner is ported.
- :class:`SoftmaxCrossEntropyLoss` — apex's module-style wrapper.

The forward kernel replaces the Pallas ``_ce_fwd_kernel``
(``apex_tpu/ops/fused_ce.py:111``, launched by ``_ce_fwd_partials``): one
program per row walks the vocabulary in ``BLOCK`` chunks keeping the running
max, the rescaled sum of exponentials, the target's logit and (smoothing
only) the raw logit sum, and writes the row's loss and its ``(m, l)`` for
the backward. The backward kernel replaces ``_ce_bwd_kernel`` (``:139``,
launched by ``_fused_xent_bwd``): one elementwise pass that recomputes
``p = exp(x - m) / l`` and writes ``(p - target) * dloss``. Both mask the
vocabulary by ``V`` (no padded columns) and take fp32, bf16 or fp16 logits
and any number of rows. The Pallas grid is sequential over vocabulary
blocks and combines per-block partials in XLA; a program per row holds the
whole reduction, so nothing is combined outside the kernel.

Bound on the H100: bytes. The forward reads the logits once (~10 flops
and two exponentials per element: each lane keeps its own running max and
sum, combined across the lanes at the end), the backward reads them and
writes the gradient once (one exponential per element):
n8192 x V32768 bf16 is 0.54 GB to read, 0.16 ms at 3.35 TB/s. As in the
JAX wrapper (``:325-329``), padding rows are zeroed in the loss, and their
``dloss`` is zeroed before the backward kernel, which multiplies every
element by it.

``softmax_cross_entropy_with_smoothing.launches`` counts forward kernel
launches and ``.bwd_launches`` backward ones (the CPU path does not count).
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch._compat import check_device_type

# ``triton.language`` is bound here on the first CUDA launch (see
# ops/layer_norm.py): importing triton at module import would break every
# CPU-only importer
tl = None
_FWD_KERNEL = None
_BWD_KERNEL = None


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------

def _pad_rows(labels, padding_idx):
    return None if padding_idx is None else labels == padding_idx


def _xent_fwd(logits, labels, smoothing, padding_idx):
    """``(loss, lse)``: the JAX ``_xent_fwd`` operation for operation, fp32
    whatever the logits' dtype."""
    logits32 = logits.float()
    m = logits32.amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.exp(logits32 - m).sum(dim=-1,
                                                      keepdim=True)))[..., 0]
    target_logit = torch.gather(logits32, -1,
                                labels.long()[..., None])[..., 0]
    nll = lse - target_logit
    if smoothing > 0.0:
        smooth_loss = lse - logits32.mean(dim=-1)
        loss = (1.0 - smoothing) * nll + smoothing * smooth_loss
    else:
        loss = nll
    pad = _pad_rows(labels, padding_idx)
    if pad is not None:
        loss = torch.where(pad, torch.zeros_like(loss), loss)
    return loss, lse


def _xent_bwd(logits, labels, lse, dloss, smoothing, padding_idx):
    """``dlogits`` in the logits' dtype: the JAX ``_xent_bwd``."""
    logits32 = logits.float()
    probs = torch.exp(logits32 - lse[..., None])
    one_hot = torch.zeros_like(probs).scatter_(-1, labels.long()[..., None],
                                               1.0)
    if smoothing > 0.0:
        target = (1.0 - smoothing) * one_hot + smoothing / logits.shape[-1]
    else:
        target = one_hot
    g = probs - target
    pad = _pad_rows(labels, padding_idx)
    if pad is not None:
        g = torch.where(pad[..., None], torch.zeros_like(g), g)
    g = g * dloss[..., None].float()
    return g.to(logits.dtype)


class _ReferenceXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, smoothing, padding_idx):
        loss, lse = _xent_fwd(logits, labels, smoothing, padding_idx)
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing, ctx.padding_idx = smoothing, padding_idx
        return loss

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, lse = ctx.saved_tensors
        return (_xent_bwd(logits, labels, lse, dloss, ctx.smoothing,
                          ctx.padding_idx), None, None, None)


def softmax_cross_entropy_reference(logits, labels, smoothing=0.0,
                                    padding_idx: Optional[int] = None):
    """Plain per-example softmax cross entropy (the JAX twin of the fused
    kernels). ``logits`` [..., V] of any float dtype, ``labels`` int
    [...]; the loss is fp32, the gradient comes back in the logits'
    dtype; ``padding_idx`` rows get zero loss and zero gradient."""
    return _ReferenceXent.apply(logits, labels, float(smoothing),
                                padding_idx)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _ce_fwd_body(X, T, LOSS, M, L, V, smoothing, BLOCK: "tl.constexpr",
                 SMOOTH: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    base = X + row * V
    tgt = tl.load(T + row)
    cols = tl.arange(0, BLOCK)
    m = tl.full([BLOCK], -1e30, tl.float32)
    l = tl.zeros([BLOCK], tl.float32)
    pred = tl.zeros([BLOCK], tl.float32)
    ssum = tl.zeros([BLOCK], tl.float32)
    for v0 in range(0, V, BLOCK):
        c = v0 + cols
        live = c < V
        x = tl.load(base + c, mask=live, other=-1e30).to(tl.float32)
        # per-lane running max and rescaled sum; dead lanes hold -1e30 and
        # drop out of the final combine below (exp(-1e30 - m) = 0)
        m_new = tl.maximum(m, x)
        l = l * tl.exp(m - m_new) + tl.exp(x - m_new)
        m = m_new
        pred += tl.where(c == tgt, x, 0.0)
        if SMOOTH:
            ssum += tl.where(live, x, 0.0)
    m_row = tl.max(m, axis=0)
    l_row = tl.sum(l * tl.exp(m - m_row), axis=0)
    nll = tl.log(l_row) + m_row - tl.sum(pred, axis=0)
    loss = nll
    if SMOOTH:
        mean_logp = tl.sum(ssum, axis=0) / V - m_row - tl.log(l_row)
        loss = (1.0 - smoothing) * nll - smoothing * mean_logp
    tl.store(LOSS + row, loss)
    tl.store(M + row, m_row)
    tl.store(L + row, l_row)


def _ce_bwd_body(X, T, M, L, DL, DX, V, smoothing, BLOCK: "tl.constexpr",
                 SMOOTH: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    tgt = tl.load(T + row)
    m = tl.load(M + row)
    l = tl.load(L + row)
    dl = tl.load(DL + row)
    cols = tl.arange(0, BLOCK)
    for v0 in range(0, V, BLOCK):
        c = v0 + cols
        live = c < V
        x = tl.load(X + row * V + c, mask=live, other=-1e30).to(
            tl.float32)
        p = tl.exp(x - m) / l
        hit = tl.where(c == tgt, 1.0, 0.0)
        if SMOOTH:
            target = (1.0 - smoothing) * hit + smoothing / V
        else:
            target = hit
        g = (p - target) * dl
        tl.store(DX + row * V + c, g.to(DX.dtype.element_ty), mask=live)


def _kernels():
    global _FWD_KERNEL, _BWD_KERNEL, tl
    if _FWD_KERNEL is None:
        import triton
        import triton.language
        tl = triton.language
        _FWD_KERNEL = triton.jit(_ce_fwd_body)
        _BWD_KERNEL = triton.jit(_ce_bwd_body)
    return _FWD_KERNEL, _BWD_KERNEL


_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MAX_BLOCK = 4096


def _block(V: int):
    """The vocabulary chunk a program loads at once, and its warps."""
    block = min(_MAX_BLOCK, 1 << max(0, (V - 1).bit_length()))
    return block, max(1, min(8, block // 256))


def _check_kernel_operands(what, lg, tgt):
    if lg.dim() != 2:
        raise ValueError(f"{what}: logits must be [n, V], got "
                         f"{tuple(lg.shape)}")
    if lg.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what}: logits dtype {lg.dtype} not in "
                         f"{_KERNEL_DTYPES}")
    if tgt.dtype != torch.int32 or tgt.shape != (lg.shape[0],):
        raise ValueError(f"{what}: labels must be int32 [{lg.shape[0]}], got "
                         f"{tgt.dtype} {tuple(tgt.shape)}")
    if tgt.device != lg.device:
        raise ValueError(f"{what}: labels lie on {tgt.device}, logits on "
                         f"{lg.device}")
    if not (lg.is_contiguous() and tgt.is_contiguous()):
        raise ValueError(f"{what}: logits and labels must be contiguous")


def _xent_fwd_cuda(lg, tgt, smoothing: float):
    """The forward kernel: ``(loss, m, l)`` fp32 [n] from logits [n, V] and
    int32 labels [n]."""
    what = "softmax_cross_entropy forward kernel"
    _check_kernel_operands(what, lg, tgt)
    n, V = lg.shape
    loss, m, l = (torch.empty(n, dtype=torch.float32, device=lg.device)
                  for _ in range(3))
    if n:
        block, warps = _block(V)
        _kernels()[0][(n,)](lg, tgt, loss, m, l, V, float(smoothing),
                            BLOCK=block, SMOOTH=smoothing > 0.0,
                            num_warps=warps)
        softmax_cross_entropy_with_smoothing.launches += 1
    return loss, m, l


def _xent_bwd_cuda(lg, tgt, m, l, dloss, smoothing: float):
    """The backward kernel: ``dlogits`` [n, V] in the logits' dtype from the
    forward's ``(m, l)`` and an fp32 ``dloss`` [n]."""
    what = "softmax_cross_entropy backward kernel"
    _check_kernel_operands(what, lg, tgt)
    n = lg.shape[0]
    for name, t in (("m", m), ("l", l), ("dloss", dloss)):
        if t.dtype != torch.float32 or t.shape != (n,) or \
                t.device != lg.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous fp32 [{n}] "
                             f"on {lg.device}")
    dlg = torch.empty_like(lg)
    if n:
        block, warps = _block(lg.shape[1])
        _kernels()[1][(n,)](lg, tgt, m, l, dloss, dlg, lg.shape[1],
                            float(smoothing), BLOCK=block,
                            SMOOTH=smoothing > 0.0, num_warps=warps)
        softmax_cross_entropy_with_smoothing.bwd_launches += 1
    return dlg


class _FusedXent(torch.autograd.Function):
    """The two kernels as one differentiable op over [n, V] logits."""

    @staticmethod
    def forward(ctx, lg, tgt, pad, smoothing):
        loss, m, l = _xent_fwd_cuda(lg, tgt, smoothing)
        if pad is not None:
            loss = torch.where(pad, torch.zeros_like(loss), loss)
        ctx.save_for_backward(lg, tgt, m, l, pad)
        ctx.smoothing = smoothing
        return loss

    @staticmethod
    def backward(ctx, dloss):
        lg, tgt, m, l, pad = ctx.saved_tensors
        dloss = dloss.float()
        if pad is not None:
            # zero loss AND zero gradient for padding rows: the kernel
            # multiplies every element of a row by its dloss
            dloss = torch.where(pad, torch.zeros_like(dloss), dloss)
        dlg = _xent_bwd_cuda(lg, tgt, m, l, dloss.contiguous(), ctx.smoothing)
        return dlg, None, None, None


def softmax_cross_entropy_with_smoothing(logits, labels, smoothing=0.0,
                                         padding_idx: Optional[int] = None,
                                         *, block_t=None, block_v=None,
                                         interpret=None, autotune=None):
    """Per-example softmax cross entropy with label smoothing (module
    docstring): the kernels on CUDA, :func:`softmax_cross_entropy_reference`
    on the CPU. ``logits`` [..., V] (contiguous on CUDA), ``labels`` int
    [...]; returns the fp32 loss shaped as ``labels``."""
    knobs = dict(block_t=block_t, block_v=block_v, interpret=interpret,
                 autotune=autotune)
    passed = sorted(k for k, v in knobs.items() if v is not None)
    if passed:
        raise NotImplementedError(
            f"softmax_cross_entropy_with_smoothing: {passed} belong to the "
            "kernel tuner, which is not ported yet; the tensor's device "
            "chooses kernel or plain version")
    smoothing = float(smoothing)
    if check_device_type(logits, "softmax_cross_entropy_with_smoothing") \
            == "cpu":
        return softmax_cross_entropy_reference(logits, labels, smoothing,
                                               padding_idx)
    V = logits.shape[-1]
    if not logits.is_contiguous():
        raise ValueError("softmax_cross_entropy_with_smoothing kernel: "
                         "logits must be contiguous")
    lead = labels.shape
    tgt = labels.reshape(-1).to(torch.int32).contiguous()
    pad = _pad_rows(tgt, padding_idx)
    loss = _FusedXent.apply(logits.reshape(-1, V), tgt, pad, smoothing)
    return loss.reshape(lead)


softmax_cross_entropy_with_smoothing.launches = 0
softmax_cross_entropy_with_smoothing.bwd_launches = 0


class SoftmaxCrossEntropyLoss:
    """Module-style wrapper mirroring
    ``apex.contrib.xentropy.SoftmaxCrossEntropyLoss``: the loss in the
    logits' dtype, or fp32 with ``half_to_float``."""

    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=0,
              half_to_float=False):
        loss = softmax_cross_entropy_with_smoothing(logits, labels,
                                                    smoothing, padding_idx)
        return loss.float() if half_to_float else loss.to(logits.dtype)
