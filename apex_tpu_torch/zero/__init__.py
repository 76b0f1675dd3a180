"""apex_tpu_torch.zero — parameter-sharded (ZeRO-3/FSDP) training
(``apex_tpu/zero``), over ``torch.distributed``.

- :mod:`~apex_tpu_torch.zero.rules` — regex table: parameter name ->
  shard/replicate, with a small-leaf size threshold;
- :mod:`~apex_tpu_torch.zero.core` — :class:`ZeroSpec`, :func:`zero_shard`,
  :func:`zero_gather` (gather behind the forward, reduce-scatter behind the
  backward), :class:`ZeroShardedModel`;
- :mod:`~apex_tpu_torch.zero.optimizer` — :class:`ZeroOptimizer`: ZeRO-1/2
  (``shard_params=False``) and ZeRO-3 (``shard_params=True``), each step
  one launch of the fused update kernel (:mod:`.fused_update`) over
  :mod:`.update`'s math;
- :mod:`~apex_tpu_torch.zero.elastic` — gather / reshard of tier-3 params
  and state across worlds, bit-exactly;
- :mod:`~apex_tpu_torch.zero.step` — :func:`make_train_step`: amp O2 and
  the loss scaler's overflow skip over shards;
- :mod:`~apex_tpu_torch.zero.comm` — the collectives (``group=`` where the
  JAX package names an ``axis_name``).

Importing builds nothing and launches nothing.
"""

from apex_tpu_torch.zero.rules import (  # noqa: F401
    DEFAULT_MIN_SHARD_SIZE,
    DEFAULT_RULES,
    REPLICATE,
    SHARD,
    match_zero_rules,
)
from apex_tpu_torch.zero.core import (  # noqa: F401
    ZeroShardedModel,
    ZeroSpec,
    build_spec,
    params_resident_bytes,
    zero_gather,
    zero_shard,
)
from apex_tpu_torch.zero.optimizer import (  # noqa: F401
    ShardedAdamState,
    ShardedLambState,
    Zero3State,
    ZeroOptimizer,
)
from apex_tpu_torch.zero.elastic import (  # noqa: F401
    gather_zero3_params,
    gather_zero3_state,
    shard_zero3_params,
    shard_zero3_state,
)
from apex_tpu_torch.zero.step import make_train_step  # noqa: F401
from apex_tpu_torch.zero import comm  # noqa: F401
