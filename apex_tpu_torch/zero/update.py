"""The sharded-optimizer update math shared by every ZeRO tier
(``apex_tpu/zero/update.py``): one Adam(W) step and LAMB's pre-trust-ratio
term on fp32 buffers of any shape.

These functions are the plain version of the B13 kernel
(``csrc/multi_tensor_update.cu`` through ``zero/fused_update.py``), and
their op order is the JAX module's, expression for expression: each
operation rounds once to fp32, and the kernel repeats the same sequence
with round-to-nearest intrinsics and no contraction, so the two agree bit
for bit on the card. Change the math here and there together.

``c1``/``c2`` are the bias-correction denominators ``1 - b^t`` as fp32
tensors: :func:`bias_corrections` computes them once, and the kernel and
this plain version read the same values.

State layouts:

- :class:`ShardedAdamState` / :class:`ShardedLambState` — tier 1/2: a
  device int32 ``step`` and three flat ``[total/world]`` fp32 buffers;
- :class:`Zero3State` — tier 3: ``master``/``m``/``v`` are ``name ->
  tensor`` mappings of the resident tree (a 1-D shard per sharded leaf,
  the full leaf per replicated one), fp32.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class ShardedAdamState(NamedTuple):
    step: torch.Tensor
    master_shard: torch.Tensor   # [total/world] fp32
    m_shard: torch.Tensor
    v_shard: torch.Tensor


class ShardedLambState(NamedTuple):
    step: torch.Tensor
    master_shard: torch.Tensor
    m_shard: torch.Tensor
    v_shard: torch.Tensor


class Zero3State(NamedTuple):
    step: torch.Tensor
    master: Any                 # name -> fp32 shard / replicated leaf
    m: Any
    v: Any


def bias_corrections(step: torch.Tensor, betas):
    """``(1 - b1^t, 1 - b2^t)`` as fp32 tensors on ``step``'s device, by
    the JAX expression ``1 - power(b, float(step))``."""
    b1, b2 = betas
    sf = step.to(torch.float32)
    return 1 - torch.pow(b1, sf), 1 - torch.pow(b2, sf)


def _corrections(step, betas, bias_correction, corrections):
    if not bias_correction:
        return None, None
    if corrections is not None:
        return corrections
    return bias_corrections(step, betas)


def _moments(p, g, m, v, beta3, b1, b2, weight_decay, adam_w_mode):
    if not adam_w_mode and weight_decay:
        g = g + weight_decay * p
    m = b1 * m + beta3 * g
    v = b2 * v + (1 - b2) * g * g
    return m, v


def _update_term(p, m, v, c1, c2, eps, weight_decay, adam_w_mode,
                 bias_correction):
    if bias_correction:
        mhat = m / c1
        vhat = v / c2
    else:
        mhat, vhat = m, v
    upd = mhat / (torch.sqrt(vhat) + eps)
    if adam_w_mode and weight_decay:
        upd = upd + weight_decay * p
    return upd


def adam_shard_step(p, g, m, v, step, *, lr, betas, eps, weight_decay,
                    adam_w_mode, bias_correction, corrections=None):
    """One Adam(W) update on a shard: ``(new_p, new_m, new_v)``, out of
    place. ``corrections``: ``(c1, c2)`` already computed (else from
    ``step``)."""
    b1, b2 = betas
    m, v = _moments(p, g, m, v, 1 - b1, b1, b2, weight_decay, adam_w_mode)
    c1, c2 = _corrections(step, betas, bias_correction, corrections)
    upd = _update_term(p, m, v, c1, c2, eps, weight_decay, adam_w_mode,
                       bias_correction)
    return p - lr * upd, m, v


def lamb_shard_term(p, g, m, v, step, *, betas, eps, weight_decay,
                    adam_w_mode, grad_averaging, bias_correction,
                    corrections=None):
    """LAMB's pre-trust-ratio update term on a shard: ``(upd, new_m,
    new_v)``. The caller takes per-tensor norms of ``p`` and ``upd``,
    applies :func:`lamb_trust_ratio` and steps ``p - lr * ratio * upd``."""
    b1, b2 = betas
    beta3 = (1 - b1) if grad_averaging else 1.0
    m, v = _moments(p, g, m, v, beta3, b1, b2, weight_decay, adam_w_mode)
    c1, c2 = _corrections(step, betas, bias_correction, corrections)
    upd = _update_term(p, m, v, c1, c2, eps, weight_decay, adam_w_mode,
                       bias_correction)
    return upd, m, v


def lamb_trust_ratio(w_norm, u_norm, *, use_nvlamb, weight_decay):
    """Per-tensor trust ratio: ``w/u``, 1 where either norm vanishes;
    plain LAMB skips the ratio at weight_decay 0 unless nvlamb."""
    ratio = torch.where((w_norm > 0) & (u_norm > 0),
                        w_norm / torch.clamp(u_norm, min=1e-30),
                        torch.ones_like(w_norm))
    if not use_nvlamb and weight_decay == 0.0:
        ratio = torch.ones_like(ratio)
    return ratio
