"""The standalone fused mask + softmax + dropout
(``apex_tpu/contrib/multihead_attn/mask_softmax_dropout.py``; apex's
``mask_softmax_dropout_func.py``): the softmax stage of attention as its
own op, with a pad mask and probability dropout whose keep mask autograd
saves for the backward (as the reference stores it). Plain PyTorch over
:func:`~apex_tpu_torch.ops.softmax.scaled_masked_softmax`; the dropout
draws from an explicit ``torch.Generator`` where the JAX op takes a key.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.softmax import scaled_masked_softmax


def fast_mask_softmax_dropout(inputs, pad_mask=None, *,
                              is_training: bool = True,
                              dropout_prob: float = 0.0,
                              generator: Optional[torch.Generator] = None,
                              scale: float = 1.0):
    """``scaled_masked_softmax(inputs, pad_mask, scale)``, then in
    training each probability kept with probability ``1 - dropout_prob``
    (a mask drawn from ``generator``, on its device) and scaled by
    ``1 / (1 - dropout_prob)``, the rest 0, in the probabilities' dtype."""
    probs = scaled_masked_softmax(inputs, pad_mask, scale)
    if is_training and dropout_prob > 0.0:
        if generator is None:
            raise ValueError("dropout requires a torch.Generator")
        keep = torch.rand(probs.shape, generator=generator,
                          device=generator.device).to(probs.device) \
            < 1.0 - dropout_prob
        probs = torch.where(keep, probs / (1.0 - dropout_prob),
                            torch.zeros_like(probs)).to(probs.dtype)
    return probs


class MaskSoftmaxDropout:
    """Module-style wrapper mirroring the reference class API."""

    def __init__(self, dropout: float = 0.0, scale: float = 1.0):
        self.dropout = dropout
        self.scale = scale

    def __call__(self, inputs, pad_mask=None, is_training: bool = True,
                 generator: Optional[torch.Generator] = None):
        return fast_mask_softmax_dropout(
            inputs, pad_mask, is_training=is_training,
            dropout_prob=self.dropout, generator=generator, scale=self.scale)
