"""The ZeRO-3 train step: amp loss scaling and the overflow skip over
sharded parameters (``apex_tpu/zero/step.py``).

The amp hot loop (``amp.make_train_step``) with two ZeRO twists:

- gradients arrive as SHARDS (``zero_gather``'s conjugate backward), so
  each rank checks only its own partition for infs, and the ``found_inf``
  flag is summed as an int32 over the group (and any ``sync_groups``) and
  compared with 0 before the skip — a rank-divergent skip would
  desynchronize the step counters and the scaler forever;
- the update is the tier-3 shard update: no parameter all-gather anywhere
  in the step.

Nothing in the step reads the device from the host: the flag, the skip
and the scaler update stay device tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.amp import scaler as _scaler_mod
from apex_tpu_torch.amp.scaler import LossScaler, ScalerState
from apex_tpu_torch.zero import comm as _comm
from apex_tpu_torch.zero.core import ZeroShardedModel

__all__ = ["make_train_step"]


def make_train_step(loss_fn: Callable,
                    zero_model: Optional[ZeroShardedModel] = None,
                    optimizer=None, *, scaler: Optional[LossScaler] = None,
                    has_aux: bool = False, grad_dtype=torch.float32,
                    donate: bool = True, sync_groups: tuple = ()):
    """Build the ZeRO-3 step.

    ``loss_fn(module, *batch) -> loss`` is written against the ORDINARY
    module, as for ``amp.make_train_step``; the step runs it with the
    module's parameters replaced by the materialized full tree, so the same
    loss function drives the dense and the sharded path. ``optimizer`` is a
    :class:`~apex_tpu_torch.zero.optimizer.ZeroOptimizer` with
    ``shard_params=True``; ``zero_model`` may be omitted when
    ``amp.initialize(..., zero=...)`` built the wrapper (it is then
    ``optimizer._zero_model``). ``sync_groups``: extra process groups whose
    ranks must agree on the skip. ``grad_dtype``: fp32 only (the unscaled
    gradient is the optimizer's fp32 flat buffer). ``donate`` is accepted
    for the JAX signature and has no meaning here: the step updates the
    resident shards and the state's buffers in place.

    ``step(shards, opt_state, scaler_state, *batch)`` returns
    ``(shards, opt_state, scaler_state, loss)`` (``+ (aux,)``), ``loss`` a
    device tensor.
    """
    del donate
    if optimizer is None:
        raise TypeError("make_train_step: optimizer is required")
    if grad_dtype != torch.float32:
        raise NotImplementedError("make_train_step: grad_dtype other than "
                                  "float32 is not ported")
    if zero_model is None:
        zero_model = getattr(optimizer, "_zero_model", None)
        if zero_model is None:
            raise ValueError(
                "make_train_step: pass zero_model, or build it through "
                "amp.initialize(..., zero=...) so the optimizer carries it "
                "(optimizer._zero_model)")
    if not _comm.same_group(getattr(optimizer, "group", None),
                            zero_model.group):
        raise ValueError(
            "make_train_step: optimizer.group is not zero_model.group. The "
            "shard update's collectives would run over another group than "
            "the gradient reduce-scatter; construct the optimizer with "
            "group=zero_model.group.")
    scaler = (scaler or getattr(optimizer, "_scaler", None)
              or LossScaler(1.0, device=_first_device(zero_model)))

    def step(shards, opt_state, scaler_state: ScalerState, *batch):
        spec = zero_model.spec
        leaves = {k: (x.detach().requires_grad_() if x.is_floating_point()
                      else x) for k, x in shards.items()}
        full = zero_model.materialize(leaves)
        out = zero_model.call(full, loss_fn, *batch)
        loss, aux = out if has_aux else (out, None)
        floats = [k for k in spec.names if shards[k].is_floating_point()]
        grads = torch.autograd.grad(
            _scaler_mod.scale_value(loss, scaler_state),
            [leaves[k] for k in floats], allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(leaves[k])
                 for g, k in zip(grads, floats)]
        del full, leaves
        g32, found_inf = _scaler_mod.unscale(grads, scaler_state)
        del grads
        # each rank inspected only its own shards: sum the flag over the
        # zero group (and any model-parallel groups) before deciding
        flag = found_inf.to(torch.int32)
        for group in (zero_model.group,) + tuple(sync_groups):
            if _comm._world_of(group) > 1:
                dist.all_reduce(flag, op=dist.ReduceOp.SUM, group=group)
        found_inf = flag > 0
        new_shards, new_state = optimizer.apply(
            opt_state, shards, g32, skip=found_inf, spec=spec)
        new_scaler_state = scaler.update_state(scaler_state, found_inf)
        outs = (new_shards, new_state, new_scaler_state, loss.detach())
        return outs + ((aux,) if has_aux else ())

    return step


def _first_device(zero_model: ZeroShardedModel) -> torch.device:
    for p in zero_model.module.parameters():
        return p.device
    raise ValueError("make_train_step: the model has no parameters")
