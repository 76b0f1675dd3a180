"""``FusedLayerNorm`` module of the port (``apex_tpu/normalization/
fused_layer_norm.py``): ``weight``/``bias`` parameters (fp32 unless
``param_dtype`` or an amp cast says otherwise), fp32 statistics, output in
``dtype`` (default: the parameter dtype), differentiable through
:func:`apex_tpu_torch.ops.layer_norm.fused_layer_norm_affine` — the Triton
forward and backward kernels on CUDA, the plain versions on the CPU."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from apex_tpu_torch._compat import as_torch_dtype, resolve_device
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine


class FusedLayerNorm(nn.Module):
    """Affine LayerNorm over the trailing ``normalized_shape`` axes.

    ``dtype`` overrides the output dtype (``None``: the parameter dtype),
    so a bf16 model gets bf16 in -> bf16 out with fp32 parameters and fp32
    math and no cast at the call site. ``device`` defaults to CUDA."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, *, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.dtype: Optional[torch.dtype] = (
            None if dtype is None else as_torch_dtype(dtype))
        pdt = as_torch_dtype(param_dtype)
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              dtype=pdt, device=device))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             dtype=pdt, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm_affine(x, self.weight, self.bias,
                                       self.normalized_shape, self.eps,
                                       self.dtype)
