"""Scaled masked softmax, the arbitrary-mask and the causal variant
(``apex_tpu/ops/softmax.py``).

Plain ``torch.autograd.Function``s with the JAX custom VJPs' formulas
(``apex_tpu/ops/softmax.py:30-98``): the forward scales in fp32, fills
masked scores with -10000 (the reference kernels' fill,
``csrc/megatron/scaled_masked_softmax.h``), takes a max-subtracted softmax
in fp32 and returns it in the input's dtype; the backward is the
recompute-free ``dx = y (dy - sum(dy y)) * scale`` from the saved output,
in fp32, returned in the output's dtype. No kernel: the JAX package has no
Pallas kernel here either. The JAX functions carry
``amp.policy.dtype_transparent``; the port has no O1 cast lists yet
(ROADMAP A4) and keeps the input's dtype as that decorator records.
"""

from __future__ import annotations

from typing import Optional

import torch

_MASK_FILL = -10000.0


def _softmax32(x32: torch.Tensor) -> torch.Tensor:
    m = x32.amax(dim=-1, keepdim=True)
    e = torch.exp(x32 - m)
    return e / e.sum(dim=-1, keepdim=True)


def _softmax_bwd(y: torch.Tensor, dy: torch.Tensor, scale: float):
    y32, dy32 = y.float(), dy.float()
    dx = y32 * (dy32 - (dy32 * y32).sum(dim=-1, keepdim=True))
    return (dx * scale).to(y.dtype)


class _ScaledMaskedSoftmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mask, scale):
        x32 = x.float() * scale
        if mask is not None:
            x32 = torch.where(mask.bool(), _MASK_FILL, x32)
        y = _softmax32(x32).to(x.dtype)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return _softmax_bwd(y, dy, ctx.scale), None, None


def scaled_masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor],
                          scale: float) -> torch.Tensor:
    """softmax(x * scale) with the scores where ``mask`` is true filled
    with -10000 first. ``mask``: boolean or 0/1 (true = masked out),
    broadcastable to ``x``; None gives the plain scaled softmax. Output in
    ``x``'s dtype, differentiable in ``x``."""
    return _ScaledMaskedSoftmax.apply(x, mask, float(scale))


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """True above the end-aligned diagonal (key past query + sk - sq)."""
    return (torch.arange(sk, device=device)[None, :]
            > torch.arange(sq, device=device)[:, None] + (sk - sq))


class _ScaledUpperTriangMaskedSoftmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale):
        sq, sk = x.shape[-2], x.shape[-1]
        x32 = torch.where(_causal_mask(sq, sk, x.device), _MASK_FILL,
                          x.float() * scale)
        y = _softmax32(x32).to(x.dtype)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return _softmax_bwd(y, dy, ctx.scale), None


def scaled_upper_triang_masked_softmax(x: torch.Tensor,
                                       scale: float) -> torch.Tensor:
    """The causal scaled softmax over ``x`` [..., sq, sk]: scores past the
    end-aligned diagonal filled with -10000
    (``csrc/megatron/scaled_upper_triang_masked_softmax.h``). Output in
    ``x``'s dtype, differentiable in ``x``."""
    return _ScaledUpperTriangMaskedSoftmax.apply(x, float(scale))
