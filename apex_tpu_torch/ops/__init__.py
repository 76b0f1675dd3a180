"""Kernel wrappers of the port, each beside its plain PyTorch version.

- :mod:`~apex_tpu_torch.ops.flash_attention` — flash-attention forward
  and backward (CUDA, ``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``: the
  single pass and the two-kernel split) and paged decode attention (CUDA,
  ``csrc/paged_decode.cu``);
- :mod:`~apex_tpu_torch.ops.layer_norm` — LayerNorm forward and backward
  (Triton);
- :mod:`~apex_tpu_torch.ops.lm_head_ce` — the fused LM-head cross entropy
  (CUDA, ``csrc/lm_head_ce.cu``);
- :mod:`~apex_tpu_torch.ops.fused_ce` — softmax cross entropy with label
  smoothing over materialized logits (Triton), re-exported by
  :mod:`~apex_tpu_torch.ops.xentropy` and ``contrib.xentropy``;
- :mod:`~apex_tpu_torch.ops.fp8_matmul` — the fp8 dequant-matmul (CUDA,
  ``csrc/fp8_matmul.cu``).

The functions below are re-exported as the JAX package's ``apex_tpu.ops``
re-exports them, except those whose names are also module names here
(``flash_attention``, ``layer_norm``): import those from their modules.

Importing this package builds nothing and imports no ``triton``: kernels
are built on their first CUDA launch (:mod:`~apex_tpu_torch.ops._build`).
"""

from apex_tpu_torch.ops.fp8_matmul import (  # noqa: F401
    fp8_dequant_matmul,
    fp8_dequant_matmul_reference,
    quantize_weight,
)
from apex_tpu_torch.ops.fused_ce import (  # noqa: F401
    softmax_cross_entropy_reference,
    softmax_cross_entropy_with_smoothing,
)
from apex_tpu_torch.ops.lm_head_ce import (  # noqa: F401
    fused_lm_head_cross_entropy,
)
