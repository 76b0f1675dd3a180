"""Zero padding that is exact, for kernels instantiated at fixed widths.

A kernel that takes only some widths runs any other width padded with
zeros where the zeros change nothing the caller keeps, as the JAX package
pads its blocks: zero columns of a contraction add exact zeros to every
sum (a head dim of q and k, the hidden size of x and the embedding, K of
the fp8 product), and the outputs' padded columns are sliced off (a head
dim of v and of the gradients, N of the fp8 product). The wrappers call
the kernel through :func:`with_padded_last_dim`; the CPU tests call it
with the plain version inside to show that the padded result is the
unpadded one bit for bit.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import torch
import torch.nn.functional as F


def pad_last_dim(t: torch.Tensor, size: int) -> torch.Tensor:
    """``t`` zero-padded along its last dim to ``size`` (``t`` itself when
    it is that wide already)."""
    width = t.shape[-1]
    if width == size:
        return t
    if width > size:
        raise ValueError(f"cannot pad width {width} down to {size}")
    if t.dtype.itemsize == 1 and t.dtype.is_floating_point:
        # fp8 has no pad kernel: pad its bytes (0x00 is +0 in e4m3/e5m2)
        return F.pad(t.view(torch.uint8), (0, size - width)).view(t.dtype)
    return F.pad(t, (0, size - width))


def with_padded_last_dim(fn: Callable, size: int,
                         tensors: Sequence[torch.Tensor],
                         sliced: Iterable[int] = ()):
    """``fn(*tensors)`` with each tensor zero-padded along its last dim to
    ``size``; the outputs at the indices ``sliced`` (of a tuple result)
    are cut back to the inputs' width, contiguous."""
    width = tensors[0].shape[-1]
    if width == size:
        return fn(*tensors)
    outs = list(fn(*(pad_last_dim(t, size) for t in tensors)))
    for i in sliced:
        outs[i] = outs[i][..., :width].contiguous()
    return tuple(outs)
