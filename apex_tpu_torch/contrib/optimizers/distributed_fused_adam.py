"""DistributedFusedAdam: ZeRO-style sharded Adam over a process group
(``apex_tpu/contrib/optimizers/distributed_fused_adam.py``).

Reference: ``apex/contrib/optimizers/distributed_fused_adam.py:55-118,
409,477`` — the flat gradient is reduce-scattered so each rank owns
1/world of it, the Adam update runs on that shard (sharded master, m and
v), and the new parameters are all-gathered back, optionally
e5m2-compressed. This class is ``ZeroOptimizer(kind="adam",
shard_params=False)``: one reduce-scatter, one fused update launch, one
all-gather a step. At world 1 it is a fused Adam over one flat buffer.
"""

from __future__ import annotations

from apex_tpu_torch.zero.optimizer import ZeroOptimizer
from apex_tpu_torch.zero.update import ShardedAdamState  # noqa: F401


class DistributedFusedAdam(ZeroOptimizer):
    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, weight_decay=0.0, adam_w_mode=True,
                 gradient_average=True, group=None,
                 compress_allgather=False, overlap_comm: bool = False,
                 autotune=None):
        super().__init__(
            lr, kind="adam", shard_params=False,
            bias_correction=bias_correction, betas=betas, eps=eps,
            weight_decay=weight_decay, adam_w_mode=adam_w_mode,
            gradient_average=gradient_average, group=group,
            compress_allgather=compress_allgather,
            overlap_comm=overlap_comm, autotune=autotune)
