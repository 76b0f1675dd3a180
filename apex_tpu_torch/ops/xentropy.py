"""Re-export of the fused softmax cross entropy, which lives in
:mod:`apex_tpu_torch.ops.fused_ce` (``apex_tpu/ops/xentropy.py``)."""

from apex_tpu_torch.ops.fused_ce import (  # noqa: F401
    SoftmaxCrossEntropyLoss,
    softmax_cross_entropy_reference,
    softmax_cross_entropy_with_smoothing,
)
