"""Fused LayerNorm forward: a Triton kernel beside its plain PyTorch version.

Port of ``apex_tpu/ops/layer_norm.py``. The kernel replaces the Pallas
``_ln_fwd_kernel`` (``apex_tpu/ops/layer_norm.py:131``, launched by
``_ln_pallas_fwd``): one row LayerNorm with fp32 statistics and the affine
epilogue, cast to ``out_dtype``.

Bound on the H100: bytes. Per row it reads ``x`` once and writes ``y``
once (the fp32 ``weight``/``bias`` are ``h`` elements shared by every row,
served from L2), with about ten flops per element — far below the card's
~295 flop/byte balance point. Design: one program per row holds the whole
row (``h = 1024`` is one block of 1024 lanes), takes mean and variance in
fp32 with block reductions and writes the affine result in the output
dtype, so ``x`` crosses HBM once and no statistics are stored. Triton is
used because the kernel is one reduction plus an elementwise epilogue; a
CUDA version would move the same bytes with more code.

The Pallas backward (``_ln_bwd_kernel``) belongs to the training slice.

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor takes
:func:`fused_layer_norm_affine_reference`.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from apex_tpu_torch._compat import check_device_type

# ``triton.language`` is bound here on the first CUDA launch: the kernel
# body below resolves ``tl`` through this module's globals, and importing
# triton at module import would break every CPU-only importer
tl = None
_KERNEL = None


def _check_shape(x, normalized_shape) -> tuple:
    shape = ((normalized_shape,) if isinstance(normalized_shape, int)
             else tuple(normalized_shape))
    if tuple(x.shape[-len(shape):]) != shape:
        raise ValueError(f"normalized_shape {shape} does not match input "
                         f"tail {tuple(x.shape[-len(shape):])}")
    return shape


def fused_layer_norm_affine_reference(x, weight, bias, normalized_shape,
                                      eps=1e-5, out_dtype=None):
    """Plain LayerNorm with affine params: fp32 statistics and math, output
    in ``out_dtype`` (default: ``weight.dtype``) — the JAX reference's
    ``_ln_fwd_affine`` operation for operation."""
    shape = _check_shape(x, normalized_shape)
    out_dtype = weight.dtype if out_dtype is None else out_dtype
    dims = tuple(range(x.dim() - len(shape), x.dim()))
    x32 = x.float()
    mean = x32.mean(dim=dims, keepdim=True)
    var = (x32 - mean).square().mean(dim=dims, keepdim=True)
    xhat = (x32 - mean) * torch.rsqrt(var + eps)
    y = xhat * weight.float() + bias.float()
    return y.to(out_dtype)


def _ln_fwd_body(X, W, B, Y, h, eps, BLOCK: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    live = cols < h
    x = tl.load(X + row * h + cols, mask=live, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / h
    xc = tl.where(live, x - mean, 0.0)
    var = tl.sum(xc * xc, axis=0) / h
    rstd = tl.math.rsqrt(var + eps)
    w = tl.load(W + cols, mask=live, other=0.0).to(tl.float32)
    b = tl.load(B + cols, mask=live, other=0.0).to(tl.float32)
    y = xc * rstd * w + b
    tl.store(Y + row * h + cols, y.to(Y.dtype.element_ty), mask=live)


def _kernel():
    global _KERNEL, tl
    if _KERNEL is None:
        import triton
        import triton.language
        tl = triton.language
        _KERNEL = triton.jit(_ln_fwd_body)
    return _KERNEL


_KERNEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_MAX_H = 16384          # one row per program, held in registers


def _ln_fwd_cuda(x, weight, bias, eps, out_dtype):
    h = x.shape[-1]
    if x.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"fused_layer_norm_affine kernel: unsupported "
                         f"dtypes x={x.dtype} out={out_dtype}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("fused_layer_norm_affine kernel: weight and bias "
                         f"must be float32, got {weight.dtype}/{bias.dtype}")
    if weight.shape != (h,) or bias.shape != (h,):
        raise ValueError(f"weight/bias must be [{h}], got "
                         f"{tuple(weight.shape)}/{tuple(bias.shape)}")
    if not (weight.is_cuda and bias.is_cuda
            and weight.device == x.device == bias.device):
        raise ValueError("fused_layer_norm_affine kernel: x, weight and "
                         "bias must lie on one CUDA device")
    if not (x.is_contiguous() and weight.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("fused_layer_norm_affine kernel: inputs must be "
                         "contiguous")
    if h > _MAX_H:
        raise ValueError(f"fused_layer_norm_affine kernel: h={h} exceeds "
                         f"{_MAX_H}")
    n = x.numel() // h
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if n == 0:
        return y
    block = 1 << (h - 1).bit_length()
    warps = max(1, min(16, block // 256))
    _kernel()[(n,)](x, weight, bias, y, h, float(eps), BLOCK=block,
                    num_warps=warps)
    fused_layer_norm_affine.launches += 1
    return y


def fused_layer_norm_affine(x, weight, bias, normalized_shape: Union[
        int, Sequence[int]], eps=1e-5, out_dtype=None):
    """Affine LayerNorm over the trailing ``normalized_shape`` axes.

    CUDA: the Triton kernel (one trailing normalized axis, fp32 params).
    CPU: :func:`fused_layer_norm_affine_reference`.
    ``fused_layer_norm_affine.launches`` counts kernel launches."""
    shape = _check_shape(x, normalized_shape)
    out_dtype = weight.dtype if out_dtype is None else out_dtype
    if check_device_type(x, "fused_layer_norm_affine") == "cpu":
        return fused_layer_norm_affine_reference(x, weight, bias, shape, eps,
                                                 out_dtype)
    if len(shape) != 1:
        raise ValueError("fused_layer_norm_affine kernel normalizes one "
                         f"trailing axis, got normalized_shape={shape}")
    return _ln_fwd_cuda(x, weight, bias, eps, out_dtype)


fused_layer_norm_affine.launches = 0
