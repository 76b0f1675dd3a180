"""Normalization modules of the port (``apex_tpu.normalization``)."""

from apex_tpu_torch.normalization.fused_layer_norm import FusedLayerNorm

__all__ = ["FusedLayerNorm"]
