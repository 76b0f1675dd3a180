"""Tensor-parallel layers of the port at world size 1
(``apex_tpu/transformer/tensor_parallel/layers.py``).

The parameters keep the JAX package's layouts, so trees carry across
unchanged: linear ``kernel`` is stored ``[in, out]`` and applied as
``x @ kernel`` (not ``nn.Linear``'s ``[out, in]``), the embedding table is
``[V, h]`` and tied to the LM head through :meth:`VocabParallelEmbedding.
attend` (and through the fused LM-head loss, which reads ``embedding``), so
its gradient sums the lookup's and the head's. Parameters are created fp32
(amp O2 casts them to bf16 in place); a forward computes in the activation
dtype (``kernel.to(x.dtype)``, a no-op once cast), so a bf16 activation
gets a bf16 product with fp32 accumulation, rounded to bf16 — the JAX
layers' ``jnp.dot(x, W.astype(x.dtype), preferred_element_type=f32)
.astype(x.dtype)``. Every layer is differentiable by autograd as it
stands.

Modules are built on ``device`` (default CUDA, which raises without a GPU).
Tensor parallelism (world > 1, sequence parallel, the comms overlap) is a
later slice: these classes take no world size.
"""

from __future__ import annotations

import torch
from torch import nn

from apex_tpu_torch._compat import resolve_device


class ColumnParallelLinear(nn.Module):
    """``y = x @ kernel + bias``, ``kernel`` [in, out] fp32."""

    def __init__(self, input_size: int, output_size: int, *,
                 use_bias: bool = True, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.kernel = nn.Parameter(torch.empty(
            (input_size, output_size), dtype=param_dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(output_size, dtype=param_dtype,
                                              device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class RowParallelLinear(ColumnParallelLinear):
    """The row-sharded twin; at world size 1 the same product."""


class VocabParallelEmbedding(nn.Module):
    """Embedding table ``embedding`` [V, h] fp32; :meth:`attend` is the
    tied LM head."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.embedding = nn.Parameter(torch.empty(
            (num_embeddings, embedding_dim), dtype=param_dtype,
            device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Logits ``x @ embedding^T`` in the activation dtype."""
        return x @ self.embedding.to(x.dtype).t()
