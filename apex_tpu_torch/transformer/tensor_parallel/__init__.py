"""Tensor-parallel layers of the port at world size 1
(``apex_tpu.transformer.tensor_parallel``)."""

from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]
