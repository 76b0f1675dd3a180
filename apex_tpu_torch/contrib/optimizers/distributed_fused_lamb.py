"""DistributedFusedLAMB: ZeRO-sharded two-phase LAMB
(``apex_tpu/contrib/optimizers/distributed_fused_lamb.py``).

Reference: ``apex/contrib/optimizers/distributed_fused_lamb.py:82-160,
556-778`` — reduce-scatter of the flat gradient, the global gradient norm
with clipping, the sharded update term, per-tensor norms summed across
ranks, the trust-ratio-scaled shard update, the all-gather of the new
parameters. This class is ``ZeroOptimizer(kind="lamb",
shard_params=False)``; the per-leaf range sums and the piecewise trust
ratio live on the shared base (``zero/optimizer.py``).
"""

from __future__ import annotations

from apex_tpu_torch.zero.optimizer import ZeroOptimizer
from apex_tpu_torch.zero.update import ShardedLambState  # noqa: F401


class DistributedFusedLAMB(ZeroOptimizer):
    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-6, weight_decay=0.01, max_grad_norm=1.0,
                 adam_w_mode=True, grad_averaging=True, use_nvlamb=False,
                 group=None, overlap_comm: bool = False, autotune=None):
        super().__init__(
            lr, kind="lamb", shard_params=False,
            bias_correction=bias_correction, betas=betas, eps=eps,
            weight_decay=weight_decay, adam_w_mode=adam_w_mode,
            gradient_average=grad_averaging, max_grad_norm=max_grad_norm,
            use_nvlamb=use_nvlamb, group=group, overlap_comm=overlap_comm,
            autotune=autotune)

    @property
    def grad_averaging(self):
        """apex's LAMB knob name (it drives both the mean over ranks and
        beta3, as in the reference)."""
        return self.gradient_average
