"""Flat-buffer utilities (``apex_tpu/utils/flat.py``): the analog of
``apex_C.flatten/unflatten``.

One contiguous buffer lets a single collective or a single kernel launch
cover many small tensors. The JAX package flattens a pytree; the port
flattens an ordered ``name -> tensor`` mapping (a module's
``named_parameters`` order) or a plain sequence of tensors.

:class:`FlatBuffer` records the layout (names, shapes, dtypes, sizes,
offsets) once; :meth:`FlatBuffer.pack` concatenates, :meth:`FlatBuffer.
unpack` splits back into views of the flat buffer (cast to each leaf's own
dtype when asked, which copies).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.utils.tree import named_tensors


@dataclass(frozen=True)
class FlatBuffer:
    """Static description of a flattening of an ordered tensor tree."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]   # start of each leaf in the flat buffer
    total: int
    is_mapping: bool = True

    @staticmethod
    def from_tree(tree: Any) -> "FlatBuffer":
        items = list(named_tensors(tree).items())
        shapes = tuple(tuple(t.shape) for _, t in items)
        sizes = tuple(int(t.numel()) for _, t in items)
        offsets, acc = [], 0
        for n in sizes:
            offsets.append(acc)
            acc += n
        return FlatBuffer(tuple(k for k, _ in items), shapes,
                          tuple(t.dtype for _, t in items), sizes,
                          tuple(offsets), acc, isinstance(tree, Mapping))

    def pack(self, tree: Any, dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
        """All leaves concatenated into one 1-D tensor (optionally cast)."""
        parts = [t.reshape(-1) for t in named_tensors(tree).values()]
        if dtype is not None:
            parts = [p.to(dtype) for p in parts]
        return torch.cat(parts) if len(parts) > 1 else parts[0].clone()

    def unpack(self, flat: torch.Tensor, dtype_from_spec: bool = True):
        """The tree back from a flat buffer: views of ``flat`` shaped as the
        leaves, cast to each leaf's dtype when ``dtype_from_spec``."""
        leaves = []
        for shape, dt, size, off in zip(self.shapes, self.dtypes, self.sizes,
                                        self.offsets):
            part = flat[off:off + size].view(shape)
            leaves.append(part.to(dt) if dtype_from_spec else part)
        if self.is_mapping:
            return dict(zip(self.names, leaves))
        return leaves


def flatten_tensors(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``apex_C.flatten``: a list of tensors -> one 1-D tensor."""
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten_tensors(flat: torch.Tensor,
                      like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``apex_C.unflatten``: views of ``flat`` shaped as ``like``."""
    parts = flat.split([t.numel() for t in like])
    return [p.view(t.shape) for p, t in zip(parts, like)]
