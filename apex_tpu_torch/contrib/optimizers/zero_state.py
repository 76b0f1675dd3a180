"""Checkpoint moves for ZeRO-sharded optimizer state: gather to a full,
topology-independent form for saving; reshard on load under a possibly
different world (``apex_tpu/contrib/optimizers/zero_state.py``).

Reference: ``apex/contrib/optimizers/distributed_fused_lamb.py:139``
``_resume_from_checkpoint``. Both tier-1/2 classes share the ``(step,
master_shard, m_shard, v_shard)`` layout. The tier-3 moves
(``apex_tpu_torch.zero.elastic``) are re-exported so every tier's
checkpoint entry points live in one module.
"""

from __future__ import annotations

from apex_tpu_torch.zero import comm as _comm
from apex_tpu_torch.zero.core import pad_to_multiple
from apex_tpu_torch.zero.elastic import (  # noqa: F401
    gather_zero3_params,
    gather_zero3_state,
    shard_zero3_params,
    shard_zero3_state,
)


def gather_zero_state(opt, state):
    """The full (unsharded) state from this rank's shards; the same on
    every rank. ``opt`` must know its flat layout (after ``init``)."""
    if opt._spec is None:
        raise ValueError("optimizer has no flat spec yet — call init() "
                         "(or pass the state through apply once) first")

    def g(x):
        return _comm.all_gather_flat(x, opt.group)[:opt._spec.total].clone()

    return type(state)(state.step.clone(), g(state.master_shard),
                       g(state.m_shard), g(state.v_shard))


def shard_zero_state(opt, full_state, params=None):
    """This rank's shard of a gathered state under the CURRENT group. Pass
    ``params`` when the optimizer is fresh (its flat layout comes from
    them)."""
    if opt._spec is None:
        if params is None:
            raise ValueError("fresh optimizer: pass params so the flat "
                             "spec can be derived")
        opt.init(params)      # sets the layout; the state is discarded
    world, rank = opt._world(), opt._rank()

    def s(x):
        flat = pad_to_multiple(x, world)
        per = flat.numel() // world
        return flat[rank * per:(rank + 1) * per].clone()

    return type(full_state)(full_state.step.clone(),
                            s(full_state.master_shard),
                            s(full_state.m_shard), s(full_state.v_shard))
