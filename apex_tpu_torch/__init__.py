"""apex_tpu_torch — the PyTorch/CUDA port of ``apex_tpu`` for NVIDIA Hopper.

The package sits beside the JAX package ``apex_tpu`` and mirrors its module
paths: ``apex_tpu/X.py`` has its counterpart at ``apex_tpu_torch/X.py``. It
imports ``torch`` and never ``jax``, ``flax`` or anything of ``apex_tpu``.

Every Pallas kernel of the JAX package becomes a kernel written by hand for
``sm_90a`` (CUDA C++ under ``csrc/``, or Triton), next to a plain PyTorch
version of the same function. A wrapper dispatches on the tensor's device:
a CUDA tensor launches the kernel (or raises), a CPU tensor takes the plain
version. Entry points default to ``device="cuda"`` and raise without a GPU
unless the caller passes ``device="cpu"``.

Ported so far:

- the serving path (``apex_tpu_torch.serve``) at tp=1 with a bf16 or fp32
  KV cache, over the flash-attention forward (prefill), paged decode
  attention and the LayerNorm forward kernels;
- O0/O2/O3 training (``apex_tpu_torch.amp``, ``apex_tpu_torch.optimizers``
  FusedAdam, ``models.gpt.GPT.loss``) over those forwards plus the
  flash-attention backward, the LayerNorm backward and the fused LM-head
  cross-entropy forward and backward kernels.
"""

__version__ = "0.1.0"
