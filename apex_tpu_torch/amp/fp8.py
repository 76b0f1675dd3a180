"""The fp8 codec of the port (``apex_tpu/amp/fp8.py:78-197``): the two wire
formats, their saturation bounds, the amax statistic, the scale rule and
the saturating cast.

Only the codec is ported. The O4 delayed-scaling recipe (``Fp8Meta``, the
amax-history ring, ``update_state``) and the ``fp8_matmul`` custom VJP come
with the O4 slice. The serve path uses the codec for its e4m3 KV pages
(``serve/cache.py``) and its e4m3 block-linear weights
(``ops/fp8_matmul.quantize_weight``).

Rounding follows the JAX package: the multiply by the scale is fp32, the
clip keeps the value inside the format (``float8_e4m3fn`` has no inf, so
an unclipped out-of-range cast gives NaN), and the cast rounds to nearest
even. The amax is taken on fp32, so no reduction runs on an fp8 tensor.
"""

from __future__ import annotations

import torch

__all__ = ["E4M3", "E5M2", "E4M3_MAX", "E5M2_MAX", "fp8_max", "amax",
           "compute_scale", "quantize", "dequantize"]

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2

# representable maxima (torch.finfo(...).max), kept as plain floats so they
# serve as default arguments
E4M3_MAX = 448.0
E5M2_MAX = 57344.0

_FP8_MAX = {E4M3: E4M3_MAX, E5M2: E5M2_MAX}


def fp8_max(dtype: torch.dtype) -> float:
    """Representable max of an fp8 wire dtype (the saturation bound)."""
    if dtype not in _FP8_MAX:
        raise ValueError(f"not an fp8 wire dtype: {dtype}")
    return _FP8_MAX[dtype]


def amax(x: torch.Tensor) -> torch.Tensor:
    """fp32 max-abs of a tensor: a 0-d fp32 tensor on ``x``'s device."""
    return x.float().abs().amax()


def compute_scale(amax_val, fmt_max: float, margin: float = 0.0
                  ) -> torch.Tensor:
    """``fmt_max / (amax * 2**margin)``: the largest multiplier that keeps
    ``amax`` (plus ``margin`` powers of two of headroom) inside the format.
    A zero or non-finite amax, or a non-finite quotient, gives 1.0, so a
    scale is always finite and positive."""
    amax_val = torch.as_tensor(amax_val, dtype=torch.float32)
    # a tensor numerator: ``float / tensor`` is computed as a reciprocal
    # times the float, which misses the rounded quotient by an ulp. A 0-d
    # CPU tensor enters a CUDA division as a scalar: no copy to the device,
    # so no host synchronisation inside the decode loop
    num = torch.tensor(fmt_max, dtype=torch.float32)
    s = num / (amax_val * (2.0 ** float(margin)))
    ok = (amax_val > 0) & torch.isfinite(amax_val) & torch.isfinite(s)
    return torch.where(ok, s, 1.0)


def quantize(x: torch.Tensor, scale, wire_dtype: torch.dtype = E5M2
             ) -> torch.Tensor:
    """Saturating cast ``clip(x * scale, ±max)`` to an fp8 wire dtype,
    with the multiply in fp32."""
    m = fp8_max(wire_dtype)
    return (x.float() * scale).clamp(-m, m).to(wire_dtype)


def dequantize(q: torch.Tensor, scale, out_dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """Invert :func:`quantize` (up to the format's rounding)."""
    return (q.float() / scale).to(out_dtype)
