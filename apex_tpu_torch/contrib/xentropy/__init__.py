"""apex_tpu_torch.contrib.xentropy — fused softmax cross entropy
(``apex_tpu/contrib/xentropy/__init__.py``): a re-export of
:mod:`apex_tpu_torch.ops.fused_ce`."""

from apex_tpu_torch.ops.fused_ce import (  # noqa: F401
    SoftmaxCrossEntropyLoss,
    softmax_cross_entropy_with_smoothing,
)
