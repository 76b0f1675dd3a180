"""Parameter-tree, dtype and flat-buffer helpers (``apex_tpu/utils/tree.py``).

The JAX package maps over a pytree; the port maps over a module's named
parameters. A parameter's path is its dotted name split at the dots —
``("block_0", "ln1", "weight")`` — which is the flax tree's path below
``params``, so a predicate written for the JAX package reads the same
names here. ``split_like`` serves the loss scaler and the fused
optimizers, which work on flat fp32 buffers.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn


def is_floating(x) -> bool:
    """True for a floating-point tensor."""
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def path_names(name: str) -> Tuple[str, ...]:
    """``"block_0.ln1.weight"`` -> ``("block_0", "ln1", "weight")``."""
    return tuple(name.split("."))


def cast_floating(module: nn.Module, dtype: torch.dtype,
                  predicate: Optional[Callable[..., bool]] = None
                  ) -> nn.Module:
    """Cast every floating parameter of ``module`` to ``dtype``, in place.

    ``predicate(path_names, param) -> bool`` can exempt parameters
    (returning False keeps the parameter untouched) — the
    ``keep_batchnorm_fp32`` rule. The ``Parameter`` objects stay the same
    (their ``data`` is replaced), so references held elsewhere see the new
    dtype. Returns ``module``."""
    for name, p in module.named_parameters():
        if not p.is_floating_point() or p.dtype == dtype:
            continue
        if predicate is None or predicate(path_names(name), p):
            p.data = p.data.to(dtype)
    return module


def tree_all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """One device bool: are ALL floating tensors finite? No host read —
    the caller decides when, if ever, to look at it."""
    flags = [torch.isfinite(t).all() for t in tensors if is_floating(t)]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


def split_like(flat: torch.Tensor,
               like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Views of ``flat`` shaped as ``like``."""
    return [c.view(t.shape) for c, t in
            zip(flat.split([t.numel() for t in like]), like)]


def named_tensors(tree) -> Dict[str, torch.Tensor]:
    """An ordered ``name -> tensor`` dict from a module (its named
    parameters), a mapping, or a sequence (names ``"0"``, ``"1"``, ...)."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    if hasattr(tree, "items"):
        return dict(tree.items())
    return {str(i): t for i, t in enumerate(tree)}
