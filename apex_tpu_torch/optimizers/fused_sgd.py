"""FusedSGD — momentum SGD (``apex_tpu/optimizers/fused_sgd.py``).

``torch.optim.SGD``'s semantics, as the JAX package writes them: weight
decay folded into the gradient (or, with ``wd_after_momentum``, into the
update after momentum), momentum with dampening, nesterov, and the
``initialized`` flag that gives the first step ``buf = g`` (torch's "first
touch", no dampening). Plain tensor math over each group's flat fp32
buffers (see ``base.py``), as the JAX package's is plain ``jnp``; the
overflow skip selects the old momentum buffer and flag bitwise.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers.base import FusedOptimizerBase


class FusedSGD(FusedOptimizerBase):
    def __init__(self, params=None, lr=1e-3, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, *,
                 wd_after_momentum=False, materialize_master_grads=True,
                 master_weights=False, set_grad_none=False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and zero "
                             "dampening")
        defaults = dict(lr=lr, momentum=momentum, dampening=dampening,
                        weight_decay=weight_decay, nesterov=nesterov)
        # the kernel flag of apex's fused_sgd.py:71
        self.wd_after_momentum = wd_after_momentum
        self.materialize_master_grads = materialize_master_grads
        super().__init__(params, defaults, master_weights=master_weights)

    def _init_slots(self, p32, group):
        if group.get("momentum", 0.0) != 0.0:
            return {"momentum_buffer": torch.zeros_like(p32),
                    "initialized": torch.zeros((), dtype=torch.bool,
                                               device=p32.device)}
        return {}

    def _update(self, p, g, slots, step, group):
        lr = group["lr"]
        momentum = group.get("momentum", 0.0)
        dampening = group.get("dampening", 0.0)
        wd = group.get("weight_decay", 0.0)
        nesterov = group.get("nesterov", False)
        if wd != 0.0 and not self.wd_after_momentum:
            g = g + wd * p
        if momentum != 0.0:
            buf = torch.where(slots["initialized"],
                              momentum * slots["momentum_buffer"]
                              + (1.0 - dampening) * g, g)
            d = g + momentum * buf if nesterov else buf
            slots = {"momentum_buffer": buf,
                     "initialized": torch.ones_like(slots["initialized"])}
        else:
            d = g
        if wd != 0.0 and self.wd_after_momentum:
            d = d + wd * p
        return p - lr * d, slots
