"""apex_tpu_torch.optimizers — fused optimizers (``apex_tpu/optimizers``).

Ported so far: the base (param groups, fp32 master weights, the device-side
overflow skip) and FusedAdam / FusedAdamW. FusedSGD, FusedLAMB,
FusedNovoGrad, FusedAdagrad and LARC come with later slices.
"""

from apex_tpu_torch.optimizers.base import (  # noqa: F401
    FusedOptimizerBase, GroupState, OptimizerState)
from apex_tpu_torch.optimizers.fused_adam import (  # noqa: F401
    FusedAdam, FusedAdamW)
