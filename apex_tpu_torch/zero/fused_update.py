"""The fused multi-tensor optimizer update (B13): one kernel launch sweeps
the flat fp32 buffer of a whole ZeRO shard (``apex_tpu/zero/fused_update.py``).

:func:`fused_shard_update` runs one Adam(W) step (``kind="adam"``) or
LAMB's pre-trust-ratio term (``kind="lamb"``) over flat fp32 buffers
``p, g, m, v``, IN PLACE: Adam writes ``p``, ``m`` and ``v`` and returns
them; LAMB writes ``m`` and ``v`` and returns a new ``upd`` buffer with
them (``p`` untouched: the trust ratio is the caller's, whose layout knows
the leaves). A device ``skip`` flag (amp's ``found_inf``) makes the update
write nothing — the buffers stay bitwise unchanged — with no host read.

- On CUDA tensors it launches ``csrc/multi_tensor_update.cu``, which
  replaces the Pallas ``_mtu_kernel`` (``apex_tpu/zero/fused_update.py:54``)
  and reads ``[lr, 1 - b1^t, 1 - b2^t]`` from one fp32 device tensor.
  ``fused_shard_update.launches`` counts Adam launches,
  ``fused_shard_update.lamb_launches`` LAMB ones.
- On CPU tensors it takes :func:`fused_shard_update_reference` — the
  ``zero/update.py`` functions plus ``torch.where`` on ``skip`` — and
  copies the result into the same buffers, so both devices share one
  contract.

The scalars come from :func:`~apex_tpu_torch.zero.update.bias_corrections`,
the expression the plain version evaluates, so the kernel and the plain
version divide by the same fp32 values and agree bit for bit on the card.
Nothing here reads the device.

The JAX tuner's knobs (``block_n``, ``interpret``) and ``autotune`` raise
``NotImplementedError`` until the port's tuner (ROADMAP A14): the kernel
needs no padding to a block, so it takes any ``n``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch._compat import check_device_type
from apex_tpu_torch.ops import _build
from apex_tpu_torch.zero.update import (adam_shard_step, bias_corrections,
                                        lamb_shard_term)

# apex_multi_tensor_update(p, g, m, v, upd, scal, skip, n, lamb, b1, beta3,
#                          b2, omb2, eps, wd, l2, decoupled, bias_correction,
#                          stream)
_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int]
         + [ctypes.c_float] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _check_kind(kind: str) -> None:
    if kind not in ("adam", "lamb"):
        raise ValueError(f"kind must be 'adam' or 'lamb', got {kind!r}")


def _no_tuner(block_n, interpret, autotune) -> None:
    for name, val in (("block_n", block_n), ("interpret", interpret),
                      ("autotune", autotune)):
        if val is not None:
            raise NotImplementedError(
                f"fused_shard_update({name}=...): the tuner's knobs are not "
                "ported yet (ROADMAP A14); the CUDA kernel takes any n")


def fused_shard_update_reference(p, g, m, v, step, *, kind: str, lr, betas,
                                 eps, weight_decay, adam_w_mode,
                                 bias_correction, grad_averaging: bool = True,
                                 skip=None, corrections=None):
    """The plain version, out of place: ``(new_p or upd, new_m, new_v)``;
    under a set ``skip`` the old ``p, m, v`` (and a zero ``upd``)."""
    _check_kind(kind)
    hyper = dict(betas=betas, eps=eps, weight_decay=weight_decay,
                 adam_w_mode=adam_w_mode, bias_correction=bias_correction,
                 corrections=corrections)
    if kind == "adam":
        out, nm, nv = adam_shard_step(p, g, m, v, step, lr=lr, **hyper)
    else:
        out, nm, nv = lamb_shard_term(p, g, m, v, step,
                                      grad_averaging=grad_averaging, **hyper)
    if skip is None:
        return out, nm, nv
    old = p if kind == "adam" else torch.zeros_like(p)
    return (torch.where(skip, old, out), torch.where(skip, m, nm),
            torch.where(skip, v, nv))


def update_scalars(lr, step, betas, bias_correction: bool,
                   device) -> torch.Tensor:
    """``[lr, 1 - b1^t, 1 - b2^t]`` (1, 1 without bias correction) as one
    fp32 tensor on ``device``, made without a host read or a copy from
    the host."""
    lr_t = (lr.to(device=device, dtype=torch.float32).reshape(())
            if isinstance(lr, torch.Tensor)
            else torch.full((), float(lr), dtype=torch.float32,
                            device=device))
    if bias_correction:
        c1, c2 = bias_corrections(step, betas)
    else:
        c1 = c2 = torch.ones((), dtype=torch.float32, device=device)
    return torch.stack([lr_t, c1.reshape(()), c2.reshape(())])


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_shard_update kernel: {msg}")


def _launch(p, g, m, v, scal, skip, *, kind, betas, eps, weight_decay,
            adam_w_mode, bias_correction, grad_averaging):
    n = p.numel()
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        _require(t.device == p.device, f"{name} lies on {t.device}, "
                 f"expected {p.device}")
        _require(t.dtype == torch.float32, f"{name} must be fp32, got "
                 f"{t.dtype}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.numel() == n, f"{name} has {t.numel()} elements, p {n}")
    if skip is not None:
        _require(skip.device == p.device and skip.dtype == torch.bool
                 and skip.numel() == 1, "skip must be one bool on the "
                 f"device, got {skip.dtype} {tuple(skip.shape)} on "
                 f"{skip.device}")
    lamb = kind == "lamb"
    upd = torch.empty_like(p) if lamb else None
    b1, b2 = betas
    beta3 = (1 - b1) if (not lamb or grad_averaging) else 1.0
    fn = _build.function("multi_tensor_update", "apex_multi_tensor_update",
                         _ARGS)
    ptr = (lambda t: None if t is None
           else ctypes.c_void_p(t.data_ptr()))
    err = fn(ptr(p), ptr(g), ptr(m), ptr(v), ptr(upd), ptr(scal), ptr(skip),
             n, int(lamb), b1, beta3, b2, 1 - b2, eps, weight_decay,
             int(not adam_w_mode and bool(weight_decay)),
             int(adam_w_mode and bool(weight_decay)), int(bias_correction),
             ctypes.c_void_p(torch.cuda.current_stream(p.device).cuda_stream))
    _build.check(err, "fused_shard_update kernel")
    if lamb:
        fused_shard_update.lamb_launches += 1
        return upd, m, v
    fused_shard_update.launches += 1
    return p, m, v


def fused_shard_update(p, g, m, v, step, *, kind: str, lr, betas, eps,
                       weight_decay, adam_w_mode, bias_correction,
                       grad_averaging: bool = True,
                       skip: Optional[torch.Tensor] = None,
                       block_n=None, interpret=None, autotune=None):
    """One Adam(W) step or LAMB term over flat fp32 buffers, in place (see
    the module docstring). ``step`` is the device int32 step of THIS
    update (the state's step plus one); ``skip`` a device bool or None.
    Returns ``(p, m, v)`` (Adam) or ``(upd, m, v)`` (LAMB)."""
    _check_kind(kind)
    _no_tuner(block_n, interpret, autotune)
    hyper = dict(kind=kind, betas=betas, eps=eps, weight_decay=weight_decay,
                 adam_w_mode=adam_w_mode, bias_correction=bias_correction,
                 grad_averaging=grad_averaging)
    scal = update_scalars(lr, step, betas, bias_correction, p.device)
    if check_device_type(p, "fused_shard_update") == "cuda":
        return _launch(p, g, m, v, scal, skip, **hyper)
    with torch.no_grad():
        out, nm, nv = fused_shard_update_reference(
            p, g, m, v, step, lr=scal[0], skip=skip,
            corrections=(scal[1], scal[2]), **hyper)
        m.copy_(nm)
        v.copy_(nv)
        if kind == "lamb":
            return out, m, v
        p.copy_(out)
        return p, m, v


fused_shard_update.launches = 0
fused_shard_update.lamb_launches = 0
