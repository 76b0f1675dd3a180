"""Fused optimizer base: whole-group updates with amp semantics
(``apex_tpu/optimizers/base.py``).

The JAX package keeps the update leaf-wise inside one jitted program. An
eager PyTorch step pays a launch per operation per tensor, so the port
keeps each param group's optimizer state as flat fp32 buffers — one master
copy, one buffer per moment — and runs the update as a handful of
whole-buffer operations per group, whatever the number of parameters.

- functional core: ``opt.init(params) -> state``; ``opt.apply(state,
  params, grads, skip=...) -> (params, state)``. ``skip`` is a device
  bool (amp's skip-on-overflow): when it is True the master weights, the
  moments and the step counter come back bitwise unchanged, selected on
  the device with ``torch.where`` — nothing is read back to the host.
- ``opt.apply_flat(state, flat_grads, skip=...)`` takes the gradients of
  every group's parameters, in order, as one flat fp32 buffer (what
  ``amp.scaler.unscale`` returns) and steps each group on its slice of
  it, with no copy; ``apply`` concatenates a list of gradients into such
  a buffer.
- master weights: with ``master_weights=True`` (amp O2) the state holds a
  persistent fp32 master, built from the parameters as they are when
  ``init`` runs — after ``AmpModel.cast_params``, as in the JAX package.
  ``apply`` writes the new master, cast to each parameter's dtype, into
  the parameters in place (the port's one departure from the JAX
  package's pure function: the parameters of an ``nn.Module`` are its
  state) and returns them.
- param groups: a list of ``{"params": [...], "lr": ..., ...}`` dicts as
  in torch; per-group hyperparameters override the defaults.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
from torch import nn

from apex_tpu_torch.utils.tree import split_like


class GroupState(NamedTuple):
    """Per-param-group state: flat fp32 buffers and a device step."""

    step: torch.Tensor            # i32 scalar, increments on applied steps
    master: Optional[torch.Tensor]  # flat fp32 master (O2) or None
    slots: dict                   # name -> flat fp32 buffer


class OptimizerState(NamedTuple):
    groups: tuple


def _param_list(params) -> List[torch.Tensor]:
    if isinstance(params, nn.Module):
        return list(params.parameters())
    return list(params)


class FusedOptimizerBase:
    """Shared machinery of the fused optimizers."""

    def __init__(self, params=None, defaults: Optional[dict] = None,
                 master_weights: bool = False):
        self.defaults = dict(defaults or {})
        self.master_weights = master_weights
        self.param_groups: List[dict] = []
        self._scaler = None
        if params is not None:
            is_group = isinstance(params, dict) and "params" in params
            self.add_param_group(params if is_group else {"params": params})

    def add_param_group(self, group: dict):
        group = dict(group)
        group["params"] = _param_list(group["params"])
        for k, v in self.defaults.items():
            group.setdefault(k, v)
        self.param_groups.append(group)

    # -- to be provided by subclasses --------------------------------------
    def _init_slots(self, p32: torch.Tensor, group: dict) -> dict:
        raise NotImplementedError

    def _update(self, p32, g32, slots, step, group):
        """Return ``(new_p32, new_slots)``: fp32 math on flat buffers,
        out of place (the caller may still select the old values)."""
        raise NotImplementedError

    # -- functional API ----------------------------------------------------
    def init(self, params=None) -> OptimizerState:
        if params is not None and not self.param_groups:
            self.add_param_group({"params": params})
        elif params is not None:
            self.param_groups[0]["params"] = _param_list(params)
        groups = []
        for group in self.param_groups:
            ps = group["params"]
            # always a fresh buffer: the master never aliases a parameter
            p32 = torch.cat([p.detach().reshape(-1).float() for p in ps])
            groups.append(GroupState(
                step=torch.zeros((), dtype=torch.int32, device=p32.device),
                master=p32 if self.master_weights else None,
                slots=self._init_slots(p32, group)))
        return OptimizerState(groups=tuple(groups))

    def apply(self, state: OptimizerState, params, grads, skip=None):
        """One optimizer step over all groups.

        ``params``/``grads``: lists of tensors (one group), or a list of
        such lists (one per group). ``skip``: device bool; True leaves the
        parameters and the state bitwise unchanged. Returns ``(params,
        new_state)``; the parameters are updated in place."""
        single = len(self.param_groups) == 1
        plist = [_param_list(params)] if single else [
            _param_list(p) for p in params]
        glist = [list(grads)] if single else [list(g) for g in grads]
        flat = torch.cat([g.reshape(-1).float() for gs in glist
                          for g in gs])
        new_state = self._step(state, plist, flat, skip)
        return (plist[0] if single else plist), new_state

    def apply_flat(self, state: OptimizerState, flat_grads: torch.Tensor,
                   skip=None) -> OptimizerState:
        """One optimizer step over all groups, the gradients given as one
        flat fp32 buffer over every group's parameters in order. The
        parameters of ``param_groups`` are updated in place; returns the
        new state."""
        return self._step(state, [g["params"] for g in self.param_groups],
                          flat_grads, skip)

    def _step(self, state, plist, flat_grads, skip):
        sizes = [sum(p.numel() for p in ps) for ps in plist]
        if flat_grads.dtype != torch.float32 or flat_grads.dim() != 1 or \
                flat_grads.numel() != sum(sizes):
            raise ValueError(f"flat gradients: expected {sum(sizes)} fp32 "
                             f"values, got {flat_grads.numel()} "
                             f"{flat_grads.dtype}")
        new_groups = []
        for group, gstate, ps, g32 in zip(self.param_groups, state.groups,
                                          plist, flat_grads.split(sizes)):
            with torch.no_grad():
                p32 = (gstate.master if gstate.master is not None
                       else torch.cat([p.detach().reshape(-1).float()
                                       for p in ps]))
                step = gstate.step + 1
                new_p32, new_slots = self._update(p32, g32, gstate.slots,
                                                  step, group)
                if skip is None:
                    new_step = step
                else:
                    new_p32 = torch.where(skip, p32, new_p32)
                    new_slots = {k: torch.where(skip, gstate.slots[k], v)
                                 for k, v in new_slots.items()}
                    new_step = torch.where(skip, gstate.step, step)
                master = new_p32 if gstate.master is not None else None
                new_groups.append(GroupState(new_step.to(torch.int32),
                                             master, new_slots))
                # model params take each leaf's own dtype (fp32 -> half
                # in O2 master mode); copy_ casts
                torch._foreach_copy_([p.data for p in ps],
                                     split_like(new_p32, ps))
        return OptimizerState(groups=tuple(new_groups))

    def master_params(self, state: OptimizerState):
        """fp32 copies of the master weights shaped as the parameters: a
        list for one group, a list of lists for several."""
        outs = []
        for group, gstate in zip(self.param_groups, state.groups):
            if gstate.master is None:
                raise ValueError("no master weights in state (master_weights"
                                 "=False)")
            outs.append([t.clone() for t in
                         split_like(gstate.master, group["params"])])
        return outs[0] if len(self.param_groups) == 1 else outs

    # -- amp hooks ---------------------------------------------------------
    def configure_amp(self, properties, scaler):
        """Called by ``amp.initialize``: adopt master-weight mode and
        attach the scaler."""
        if properties.master_weights:
            self.master_weights = True
        self._scaler = scaler
