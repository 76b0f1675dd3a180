"""Ports of the JAX package's ``scripts/`` that hold a kernel, each a
module run as ``python -m apex_tpu_torch.scripts.<name>``:
:mod:`~apex_tpu_torch.scripts.vpu_probe` (the per-op cost probe) and
:mod:`~apex_tpu_torch.scripts.bottleneck_proto` (the fused conv2_x
bottleneck)."""
