"""fp8 dequant-matmul for serve weight streaming: a CUDA kernel beside its
plain PyTorch version (``apex_tpu/ops/fp8_matmul.py``).

Decode is bound by the weights' bytes: every block linear is read once per
step. Storing its kernel as e4m3 with one per-tensor scale (the
``amp.fp8`` codec) halves the bytes against bf16, and this module is the
product that consumes them:

- :func:`quantize_weight` — the build-time half: a per-tensor amax scale
  (``compute_scale`` against the e4m3 max, with ``margin`` powers of two
  of headroom) and the saturating e4m3 cast;
- :func:`fp8_dequant_matmul_reference` — the plain version:
  ``(x.float() @ (q.float() / scale)).to(out_dtype)``;
- :func:`fp8_dequant_matmul` — the JAX guards (e4m3 weight, matching
  contraction), then on CUDA the kernel ``csrc/fp8_matmul.cu``, which
  replaces the Pallas ``_fp8_mm_kernel`` (``apex_tpu/ops/fp8_matmul.py:76``)
  and never writes a dequantized weight; on the CPU the plain version.
  ``fp8_dequant_matmul.launches`` counts kernel launches,
  ``.prefill_launches`` those of the prefill regime. Every call is
  one device launch with no workspace: at m <= 8 (the decode regime) the
  K splits of a 64-column tile (:func:`_splits`) meet on chip; at m > 8
  (the prefill regime, wgmma/TMA) blocks of 128 columns by 128 or 64 rows,
  K split across a cluster of two where :func:`_prefill_plan` says so.

The kernel takes bf16 ``x`` and gives a bf16 result (``out_dtype`` must be
``x.dtype``; the serve engines run bf16, and another x raises where the JAX
package takes any float x: ROADMAP §C) and runs K and N in multiples of 16:
any other K or N runs zero-padded (:func:`with_padded_kn`, as the JAX
package pads to its blocks, ``apex_tpu/ops/fp8_matmul.py:109-118``): zero
rows of the weight meet zero columns of x, and the padded output columns
are sliced off. The scale stays on
the device: the kernel reads it, the host never does. The Pallas block
knobs and the tuned-cache lookup of the JAX entry wait for the port's
tuner.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch._compat import check_device_type
from apex_tpu_torch.amp import fp8
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._pad import pad_last_dim


def quantize_weight(w: torch.Tensor, *, margin: float = 0.0):
    """One weight matrix -> ``(q e4m3, scale)``, ``scale`` a 0-d fp32
    tensor on ``w``'s device: what :func:`fp8_dequant_matmul` divides back
    out."""
    scale = fp8.compute_scale(fp8.amax(w), fp8.E4M3_MAX, margin)
    return fp8.quantize(w, scale, fp8.E4M3), scale


def fp8_dequant_matmul_reference(x, q, scale, out_dtype=None):
    """Dequantize the e4m3 weight to fp32, contract with fp32 accumulation,
    cast to ``out_dtype`` (default ``x.dtype``). ``x``: [..., K]; ``q``:
    [K, N] e4m3; ``scale``: fp32 scalar."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    w = fp8.dequantize(q, scale, torch.float32)
    return (x.float() @ w).to(out_dtype)


# apex_fp8_matmul(x, q, scale, y, m, K, N, bm, splits, kc, stream)
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_TILE_N = 64             # the decode regime's columns a block
_STAGE_K = 64            # weight rows of one stage of its TMA ring
_MAX_SPLITS = 8          # a portable cluster
_MIN_SPLIT_K = 128       # rows a split takes at least (two stages)
_FILL = 128              # blocks to aim at: about one per SM of an H100


def _splits(K: int, N: int):
    """The decode regime's K split ``(splits, kc)``: the K splits of a
    column tile (one thread-block cluster of 1, 2, 4 or 8 blocks, so that
    each owns a whole share of the tile's 64 columns; the fewest that give
    about one block an SM) and the rows each takes (whole 64-row stages;
    ``splits * kc >= K``). A function of (K, N) alone, so a row's sum
    order never depends on how many rows come with it."""
    tiles = -(-N // _TILE_N)
    splits = 1
    while (splits < _MAX_SPLITS and tiles * splits < _FILL
           and 2 * splits * _MIN_SPLIT_K <= K):
        splits *= 2
    kc = -(-K // (splits * _STAGE_K)) * _STAGE_K
    return splits, kc


_PF_TILE_N = 128         # the prefill regime's columns a block
_PF_ROWS = 512           # the serve engines' prefill rows (max_prompt_len)
_PF_SMS = 132            # an H100's SMs: blocks of one wave at _PF_ROWS
_PF_FULL = 96            # blocks that fill the card well enough at 128 rows


def _prefill_plan(K: int, N: int):
    """The prefill regime's tiles and K split ``(bm, splits, kc)``, sized
    for the engines' prefill (every prompt is padded to 512 rows): 128 rows
    a block where an m512 call then has at least ``_PF_FULL`` blocks; else
    64 rows and two splits (a thread-block cluster of two blocks along K
    per tile, each split at least two 64-row stages) where that keeps the
    blocks in one wave of the card's SMs (a cluster of four, 30 of which
    fit on an H100 at once, would run two waves); else the row tile with
    more blocks in one wave; and the rows each split takes (whole stages;
    ``splits * kc >= K``). A function of (K, N) alone: a row's sum order
    never depends on m, so its bits do not depend on the rows that come
    with it."""
    tiles = -(-_PF_ROWS // 128) * -(-N // _PF_TILE_N)     # at 128 rows
    if tiles >= _PF_FULL:
        bm, splits = 128, 1
    elif 2 * 2 * tiles <= _PF_SMS and K >= 4 * _STAGE_K:
        bm, splits = 64, 2
    else:
        bm, splits = (64, 1) if 2 * tiles <= _PF_SMS else (128, 1)
    kc = -(-K // (splits * _STAGE_K)) * _STAGE_K
    return bm, splits, kc


def launch_plan(m: int, K: int, N: int):
    """``(regime, bm, splits, kc)`` of a call over ``m`` rows: the decode
    regime (m <= 8, all rows in one block: :func:`_splits`) or the prefill
    regime (:func:`_prefill_plan`), as the wrapper hands them to the
    kernel."""
    if m <= 8:
        return ("decode", 8) + _splits(K, N)
    return ("prefill",) + _prefill_plan(K, N)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fp8_dequant_matmul kernel: {msg}")


_ALIGN = 16      # the kernel's K and N granule


def with_padded_kn(fn, x, q, scale, out_dtype):
    """``fn(x, q, scale, out_dtype)`` at K and N rounded up to multiples of
    16 with zeros (x's columns and q's rows past K, q's columns past N),
    the result's padded columns sliced off."""
    K, N = q.shape
    Kp, Np = -(-K // _ALIGN) * _ALIGN, -(-N // _ALIGN) * _ALIGN
    if (Kp, Np) == (K, N):
        return fn(x, q, scale, out_dtype)
    qp = pad_last_dim(pad_last_dim(q, Np).t(), Kp).t().contiguous()
    y = fn(pad_last_dim(x, Kp).contiguous(), qp, scale, out_dtype)
    return y[..., :N].contiguous()


def _fp8_mm_cuda(x, q, scale, out_dtype):
    return with_padded_kn(_fp8_mm_launch, x, q, scale, out_dtype)


def _fp8_mm_launch(x, q, scale, out_dtype):
    K, N = q.shape
    _require(x.dtype == torch.bfloat16 and out_dtype == torch.bfloat16,
             f"takes a bfloat16 x and gives bfloat16, got x {x.dtype} -> "
             f"{out_dtype}")
    _require(K % _ALIGN == 0 and N % _ALIGN == 0,
             f"K and N must be multiples of 16, got q [{K}, {N}]")
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        _require(t.device == x.device,
                 f"{name} lies on {t.device}, expected {x.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(scale.dtype == torch.float32 and scale.numel() == 1,
             f"scale must be one fp32 value, got {scale.dtype} "
             f"{tuple(scale.shape)}")
    _require(x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0,
             "x and q must be 16-byte aligned")
    lead = x.shape[:-1]
    m = x.numel() // K
    y = torch.empty((m, N), dtype=torch.bfloat16, device=x.device)
    _, bm, splits, kc = launch_plan(m, K, N)
    fn = _build.function("fp8_matmul", "apex_fp8_matmul", _ARGS)
    err = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(q.data_ptr()),
             ctypes.c_void_p(scale.data_ptr()), ctypes.c_void_p(y.data_ptr()),
             m, K, N, bm, splits, kc,
             ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(err, "fp8_dequant_matmul kernel")
    fp8_dequant_matmul.launches += 1
    if m > 8:
        fp8_dequant_matmul.prefill_launches += 1
    return y.reshape(lead + (N,))


def fp8_dequant_matmul(x, q, scale, out_dtype: Optional[torch.dtype] = None):
    """``x @ dequantize(q, scale)``: the kernel on CUDA,
    :func:`fp8_dequant_matmul_reference` on the CPU."""
    if q.dtype != fp8.E4M3:
        raise ValueError(
            f"fp8_dequant_matmul: weight must be e4m3, got {q.dtype}")
    if q.dim() != 2 or x.shape[-1] != q.shape[0]:
        raise ValueError(
            f"fp8_dequant_matmul: contraction mismatch, "
            f"x[..., {x.shape[-1]}] @ q{list(q.shape)}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if check_device_type(x, "fp8_dequant_matmul") == "cpu":
        return fp8_dequant_matmul_reference(x, q, scale, out_dtype)
    return _fp8_mm_cuda(x, q, scale, out_dtype)


fp8_dequant_matmul.launches = 0
fp8_dequant_matmul.prefill_launches = 0
