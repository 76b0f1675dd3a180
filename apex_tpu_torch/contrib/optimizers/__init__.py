"""apex_tpu_torch.contrib.optimizers — the ZeRO-sharded optimizers
(``apex_tpu/contrib/optimizers``).

``DistributedFusedAdam`` and ``DistributedFusedLAMB`` are
``ZeroOptimizer(shard_params=False)`` with the reference's defaults; the
tier-1/2 checkpoint moves are in :mod:`.zero_state`. ``FP16_Optimizer``
comes with a later slice.
"""

from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import \
    DistributedFusedAdam  # noqa: F401
from apex_tpu_torch.contrib.optimizers.distributed_fused_lamb import \
    DistributedFusedLAMB  # noqa: F401
