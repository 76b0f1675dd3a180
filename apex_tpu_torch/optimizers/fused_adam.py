"""FusedAdam — Adam/AdamW (``apex_tpu/optimizers/fused_adam.py``).

The JAX package's update, expression for expression: two moment EMAs,
bias correction from the device step counter, decoupled (AdamW) or L2
weight decay, all in fp32. Plain tensor math over each group's flat
buffers (see ``base.py``), as the JAX package's is plain ``jnp``: no
kernel of its own.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers.base import FusedOptimizerBase


class FusedAdam(FusedOptimizerBase):
    def __init__(self, params=None, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, *, master_weights=False):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay)
        self.adam_w_mode = adam_w_mode
        super().__init__(params, defaults, master_weights=master_weights)

    def _init_slots(self, p32, group):
        return {"exp_avg": torch.zeros_like(p32),
                "exp_avg_sq": torch.zeros_like(p32)}

    def _update(self, p, g, slots, step, group):
        lr = group["lr"]
        beta1, beta2 = group["betas"]
        eps = group["eps"]
        wd = group.get("weight_decay", 0.0)
        if group.get("bias_correction", True):
            stepf = step.float()
            bc1 = 1.0 - torch.pow(beta1, stepf)
            bc2 = 1.0 - torch.pow(beta2, stepf)
        else:
            bc1 = bc2 = 1.0
        if not self.adam_w_mode and wd != 0.0:
            g = g + wd * p                      # L2: decay in the gradient
        m = beta1 * slots["exp_avg"] + (1.0 - beta1) * g
        v = beta2 * slots["exp_avg_sq"] + (1.0 - beta2) * g * g
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if self.adam_w_mode and wd != 0.0:
            update = update + wd * p
        return p - lr * update, {"exp_avg": m, "exp_avg_sq": v}


class FusedAdamW(FusedAdam):
    """Decoupled weight decay always on."""

    def __init__(self, params=None, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=1e-2, **kw):
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay, adam_w_mode=True, **kw)
