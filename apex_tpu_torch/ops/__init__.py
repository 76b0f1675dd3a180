"""Kernel wrappers of the port, each beside its plain PyTorch version.

- :mod:`~apex_tpu_torch.ops.flash_attention` — flash-attention forward
  (CUDA, ``csrc/flash_fwd.cu``) and paged decode attention (CUDA,
  ``csrc/paged_decode.cu``);
- :mod:`~apex_tpu_torch.ops.layer_norm` — LayerNorm forward (Triton).

Importing this package builds nothing and imports no ``triton``: kernels
are built on their first CUDA launch (:mod:`~apex_tpu_torch.ops._build`).
"""
