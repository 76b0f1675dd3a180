"""Tensor-parallel layers and the vocab-parallel cross entropy of the port
at world size 1 (``apex_tpu.transformer.tensor_parallel``)."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "vocab_parallel_cross_entropy"]
