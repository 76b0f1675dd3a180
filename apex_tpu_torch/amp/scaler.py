"""Loss scaling, static or dynamic, with the state on the device
(``apex_tpu/amp/scaler.py``).

The scaler is a set of functions over a small :class:`ScalerState` of
device tensors. :func:`update` is branch-free (``torch.where``), so the
whole scale → backward → unscale → check → update → maybe-skip loop of
:func:`~apex_tpu_torch.amp.make_train_step` reads nothing back to the
host. ``LossScaler.loss_scale()`` and the state-dict helpers do read it,
for logging and checkpoints.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch

from apex_tpu_torch._compat import DeviceLike, resolve_device


class ScalerState(NamedTuple):
    """Device-resident dynamic loss-scaler state."""

    loss_scale: torch.Tensor   # f32 scalar, current scale
    unskipped: torch.Tensor    # i32 scalar, clean steps since last change
    overflow: torch.Tensor     # bool scalar, last step overflowed


def init_state(init_scale: float = 2.0 ** 16,
               device: DeviceLike = None) -> ScalerState:
    dev = resolve_device(device)
    return ScalerState(
        loss_scale=torch.tensor(init_scale, dtype=torch.float32, device=dev),
        unskipped=torch.tensor(0, dtype=torch.int32, device=dev),
        overflow=torch.tensor(False, device=dev))


def scale_value(loss: torch.Tensor, state: ScalerState) -> torch.Tensor:
    """``loss.float() * loss_scale``."""
    return loss.float() * state.loss_scale


def unscale(grads: Sequence[torch.Tensor], state: ScalerState):
    """Unscale a list of gradients and detect overflow.

    Returns ``(flat, found_inf)``: ``flat`` is one fp32 buffer holding
    ``grads[i].float() * (1 / scale)`` for every ``i`` in order (the form
    ``FusedOptimizerBase.apply_flat`` takes; ``split_like(flat, grads)``
    gives the per-tensor views), and ``found_inf`` a device bool, True when
    any gradient holds an inf or a nan. The check reads the fp32 copy of
    the gradients before the multiply (the cast is exact), so detection
    and update see the same values, as the JAX package's fp16 barrier
    guarantees there."""
    inv = torch.where(state.loss_scale > 0, 1.0 / state.loss_scale,
                      torch.ones_like(state.loss_scale))
    flat = torch.cat([g.reshape(-1) for g in grads]).float()
    found_inf = ~torch.isfinite(flat).all()
    return flat.mul_(inv), found_inf


def update(state: ScalerState, found_inf: torch.Tensor, *, dynamic: bool,
           scale_factor: float = 2.0, scale_window: int = 2000,
           min_loss_scale: Optional[float] = None,
           max_loss_scale: float = 2.0 ** 24) -> ScalerState:
    """On overflow: scale /= scale_factor (clamped below by
    ``min_loss_scale``) and the counter resets. Every ``scale_window``
    clean steps: scale *= scale_factor (clamped by ``max_loss_scale``).
    Static scaling keeps the scale and records the flag."""
    if not dynamic:
        return ScalerState(state.loss_scale, state.unskipped, found_inf)
    floor = max(min_loss_scale if min_loss_scale is not None else 0.0,
                1.0e-8)
    shrunk = torch.clamp(state.loss_scale / scale_factor, min=floor)
    unskipped = torch.where(found_inf, torch.zeros_like(state.unskipped),
                            state.unskipped + 1)
    grow = unskipped >= scale_window
    grown = torch.clamp(state.loss_scale * scale_factor, max=max_loss_scale)
    new_scale = torch.where(found_inf, shrunk,
                            torch.where(grow, grown, state.loss_scale))
    unskipped = torch.where(grow, torch.zeros_like(unskipped), unskipped)
    return ScalerState(new_scale, unskipped.to(torch.int32), found_inf)


class LossScaler:
    """The apex object API over :class:`ScalerState`: ``loss_scale=
    "dynamic"`` or a float, ``scale_window`` and the clamps."""

    def __init__(self, loss_scale: Union[float, str] = "dynamic",
                 init_scale: float = 2.0 ** 16, scale_factor: float = 2.0,
                 scale_window: int = 2000,
                 min_loss_scale: Optional[float] = None,
                 max_loss_scale: float = 2.0 ** 24, *,
                 device: DeviceLike = None):
        self.dynamic = loss_scale == "dynamic"
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._min_loss_scale = min_loss_scale
        self._max_loss_scale = max_loss_scale
        init = init_scale if self.dynamic else float(loss_scale)
        self.state = init_state(init, device)

    def update_state(self, state: ScalerState, found_inf) -> ScalerState:
        return update(state, found_inf, dynamic=self.dynamic,
                      scale_factor=self._scale_factor,
                      scale_window=self._scale_window,
                      min_loss_scale=self._min_loss_scale,
                      max_loss_scale=self._max_loss_scale)

    # -- host-side conveniences (each reads the device) ---------------------
    def loss_scale(self) -> float:
        return float(self.state.loss_scale)

    def state_dict(self) -> dict:
        return {"loss_scale": float(self.state.loss_scale),
                "unskipped": int(self.state.unskipped),
                "dynamic": self.dynamic}

    def load_state_dict(self, sd: dict):
        self.dynamic = sd.get("dynamic", self.dynamic)
        dev = self.state.loss_scale.device
        self.state = ScalerState(
            torch.tensor(sd["loss_scale"], dtype=torch.float32, device=dev),
            torch.tensor(sd.get("unskipped", 0), dtype=torch.int32,
                         device=dev),
            torch.tensor(False, device=dev))
