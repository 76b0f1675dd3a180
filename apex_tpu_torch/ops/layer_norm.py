"""Fused LayerNorm, forward and backward: a Triton forward and a CUDA backward
kernel beside their plain PyTorch versions.

Port of ``apex_tpu/ops/layer_norm.py``. The forward kernel replaces the Pallas
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

The backward kernel, ``csrc/layer_norm_bwd.cu`` (CUDA C++), replaces the
Pallas ``_ln_bwd_kernel`` (``:141``, launched by ``_ln_pallas_bwd``
``:197``): ``dx`` and the dgamma/dbeta sums from one read of ``x`` and
``dy``, in one launch. Bound: bytes — x, dy read and dx written once (3 x
16 MB in bf16 at the training shape [8192, 1024]), about 20 flops per
element. As the Pallas kernel does, it recomputes mean and invvar from
``x`` instead of saving them, so the autograd function keeps only ``(x,
weight)``. The TPU kernel carries dgamma/dbeta across its sequential row
grid in VMEM; on the card a warp (h <= 1024) or a block (larger h) owns a
row, blocks walk contiguous row ranges (:func:`_ln_bwd_plan`) keeping
their partials in fp32, and the blocks' partials meet in the same launch,
in block order, behind a grid barrier (a cooperative launch): the kernel
writes dgamma and dbeta in their dtypes, with no second pass. Why CUDA and
not Triton: the cross-block sum in a fixed order inside one launch and the
explicit prefetch of the next rows do not fit Triton's one-program model.

Dispatch: a CUDA tensor launches the kernels (or raises), a CPU tensor
takes :func:`fused_layer_norm_affine_reference` and
:func:`layer_norm_bwd_reference`. :func:`fused_layer_norm_affine` is
differentiable through :class:`FusedLayerNormAffineFunction`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Union

import torch

from apex_tpu_torch._compat import check_device_type
from apex_tpu_torch.ops import _build

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
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def _ln_fwd_cuda(x, weight, bias, eps, out_dtype):
    h = x.shape[-1]
    if x.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"fused_layer_norm_affine kernel: unsupported "
                         f"dtypes x={x.dtype} out={out_dtype}")
    if weight.dtype not in _KERNEL_DTYPES or bias.dtype not in _KERNEL_DTYPES:
        raise ValueError("fused_layer_norm_affine kernel: weight and bias "
                         "must be float32, bfloat16 or float16, got "
                         f"{weight.dtype}/{bias.dtype}")
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


def layer_norm_bwd_reference(x, weight, dy, normalized_shape, eps=1e-5,
                             bias_dtype=None):
    """Plain LayerNorm backward — the JAX ``_ln_bwd_affine`` operation for
    operation, with mean and invvar recomputed from ``x``. Returns ``(dx
    in x.dtype, dweight in weight.dtype, dbias in bias_dtype)``."""
    shape = _check_shape(x, normalized_shape)
    bias_dtype = weight.dtype if bias_dtype is None else bias_dtype
    axes = tuple(range(x.dim() - len(shape), x.dim()))
    x32 = x.float()
    dy32 = dy.float()
    mean = x32.mean(dim=axes, keepdim=True)
    var = (x32 - mean).square().mean(dim=axes, keepdim=True)
    invvar = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * invvar
    dxhat = dy32 * weight.float()
    n = 1
    for a in axes:
        n *= x.shape[a]
    s1 = dxhat.sum(dim=axes, keepdim=True)
    s2 = (dxhat * xhat).sum(dim=axes, keepdim=True)
    dx = (invvar / n) * (n * dxhat - s1 - xhat * s2)
    red = tuple(range(x.dim() - len(shape)))
    dw = (dy32 * xhat).sum(dim=red)
    db = dy32.sum(dim=red)
    return dx.to(x.dtype), dw.to(weight.dtype), db.to(bias_dtype)


# apex_layer_norm_bwd(x, w, dy, dx, ws, dw, db, n, h, eps, variant, blocks,
#                     rows_per_block, xc, wc, dyc, dwc, dbc, stream)
_BWD_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_float]
             + [ctypes.c_int] * 8 + [ctypes.c_void_p])
_WARP_ROWS_MAX_H = 1024   # a warp holds a row: 32 lanes x 8 columns x 4
_BWD_WARPS = 8            # the warp-rows kernel's warps a block
_SMS = 132                # an H100's SMs: the plan's default


def _ln_bwd_plan(n: int, h: int, sms: int = _SMS):
    """``(variant, blocks, rows_per_block)`` of the backward kernel:
    ``"warp_rows"`` (a warp a row, h <= 1024) or ``"block_rows"`` (a block
    a row); at most one block an SM (the blocks meet behind a grid
    barrier), each walking ``rows_per_block`` consecutive rows — the fewest
    rows that give every block of the launch work (one block and no row at
    n = 0). The rows' order within a block and the blocks' order fix every
    fp32 sum of dgamma and dbeta: warp by warp over its rows (warp w takes
    the block's rows w, w + 8, ...), the warps in order, the blocks in
    order."""
    variant = "warp_rows" if h <= _WARP_ROWS_MAX_H else "block_rows"
    unit = _BWD_WARPS if variant == "warp_rows" else 1
    blocks = max(1, min(sms, -(-n // unit)))
    rows = -(-n // blocks)
    if rows:
        blocks = -(-n // rows)
    return variant, blocks, rows


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ln_bwd_cuda(x, weight, dy, eps, bias_dtype):
    h = x.shape[-1]
    what = "layer_norm_bwd kernel"
    for name, t in (("x", x), ("dy", dy), ("weight", weight)):
        if t.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"{what}: unsupported dtype {name}={t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} lies on {t.device}, expected "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if bias_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what}: unsupported bias dtype {bias_dtype}")
    if dy.shape != x.shape or weight.shape != (h,):
        raise ValueError(f"{what}: dy {tuple(dy.shape)} / weight "
                         f"{tuple(weight.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if h > _MAX_H:
        raise ValueError(f"{what}: h={h} exceeds {_MAX_H}")
    n = x.numel() // h
    variant, blocks, rows = _ln_bwd_plan(n, h, _sm_count(x.device))
    dx = torch.empty_like(x)
    ws = torch.empty((blocks, 2, h), dtype=torch.float32, device=x.device)
    dw = torch.empty((h,), dtype=weight.dtype, device=x.device)
    db = torch.empty((h,), dtype=bias_dtype, device=x.device)
    fn = _build.function("layer_norm_bwd", "apex_layer_norm_bwd", _BWD_ARGS)
    err = fn(*(ctypes.c_void_p(t.data_ptr())
               for t in (x, weight, dy, dx, ws, dw, db)),
             n, h, float(eps), 0 if variant == "warp_rows" else 1, blocks,
             rows, _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype],
             _DTYPE_CODES[dy.dtype], _DTYPE_CODES[weight.dtype],
             _DTYPE_CODES[bias_dtype],
             ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(err, what)
    layer_norm_bwd.launches += 1
    if variant == "block_rows":
        layer_norm_bwd.block_rows_launches += 1
    return dx, dw, db


def layer_norm_bwd(x, weight, dy, normalized_shape, eps=1e-5,
                   bias_dtype=None):
    """``(dx, dweight, dbias)`` of the affine LayerNorm: the CUDA kernel
    ``csrc/layer_norm_bwd.cu`` on CUDA (one trailing normalized axis, one
    launch a call), :func:`layer_norm_bwd_reference` on the CPU.
    ``layer_norm_bwd.launches`` counts kernel launches,
    ``.block_rows_launches`` those of the block-rows kernel (h > 1024)."""
    shape = _check_shape(x, normalized_shape)
    bias_dtype = weight.dtype if bias_dtype is None else bias_dtype
    if check_device_type(x, "layer_norm_bwd") == "cpu":
        return layer_norm_bwd_reference(x, weight, dy, shape, eps,
                                        bias_dtype)
    if len(shape) != 1:
        raise ValueError("layer_norm_bwd kernel normalizes one trailing "
                         f"axis, got normalized_shape={shape}")
    return _ln_bwd_cuda(x, weight, dy, eps, bias_dtype)


layer_norm_bwd.launches = 0
layer_norm_bwd.block_rows_launches = 0


def _ln_fwd(x, weight, bias, shape, eps, out_dtype):
    if check_device_type(x, "fused_layer_norm_affine") == "cpu":
        return fused_layer_norm_affine_reference(x, weight, bias, shape, eps,
                                                 out_dtype)
    if len(shape) != 1:
        raise ValueError("fused_layer_norm_affine kernel normalizes one "
                         f"trailing axis, got normalized_shape={shape}")
    return _ln_fwd_cuda(x, weight, bias, eps, out_dtype)


class FusedLayerNormAffineFunction(torch.autograd.Function):
    """The forward kernel and the backward kernel as one differentiable
    op. Saves ``(x, weight)``; the backward recomputes the statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, shape, eps, out_dtype):
        ctx.save_for_backward(x, weight)
        ctx.shape, ctx.eps, ctx.bias_dtype = shape, eps, bias.dtype
        return _ln_fwd(x, weight, bias, shape, eps, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x, weight, dy.contiguous(), ctx.shape,
                                    ctx.eps, ctx.bias_dtype)
        return dx, dw, db, None, None, None


def fused_layer_norm_affine(x, weight, bias, normalized_shape: Union[
        int, Sequence[int]], eps=1e-5, out_dtype=None):
    """Affine LayerNorm over the trailing ``normalized_shape`` axes,
    differentiable in ``x``, ``weight`` and ``bias``.

    CUDA: the Triton forward and the CUDA backward (one trailing
    normalized axis; params in fp32, bf16 or fp16). CPU: the plain
    versions.
    ``fused_layer_norm_affine.launches`` counts forward launches,
    ``layer_norm_bwd.launches`` backward ones."""
    shape = _check_shape(x, normalized_shape)
    out_dtype = weight.dtype if out_dtype is None else out_dtype
    return FusedLayerNormAffineFunction.apply(x, weight, bias, shape,
                                              float(eps), out_dtype)


fused_layer_norm_affine.launches = 0
