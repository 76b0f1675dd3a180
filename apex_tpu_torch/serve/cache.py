"""Paged KV cache of the port (``apex_tpu/serve/cache.py``): a preallocated
page pool plus per-sequence block tables.

The pool is allocated once (:func:`init_cache`) and never reshaped. Every
cache mutation writes into it in place — the JAX package donates the pool
through each jitted step for the same effect — so one pool is resident,
never two. Layout (the ``ops.flash_attention.paged_decode_attention``
contract)::

    k_pool / v_pool   [num_layers, kv_heads, num_pages, page_size, d]

Page 0 is the null page: the host allocator never hands it out, and every
masked write (inactive batch slots, prompt padding) is routed to it, so a
scatter needs no branch and nothing ever reads the null page as live.
Several masked writes of one call may land on the same null-page cell;
which one wins does not matter.

Page size resolves explicit > heuristic; the JAX package's tuned cache
between the two is not ported yet. fp8-KV pools come with the fp8 serve
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from apex_tpu_torch._compat import DeviceLike, as_torch_dtype, resolve_device

#: heuristic default page size: a 1k-token context is 8 pages, and the
#: per-sequence tail waste (page_size/2 tokens on average) stays a few
#: percent at chat lengths
DEFAULT_PAGE_SIZE = 128


def resolve_page_size(*, context_len: int,
                      page_size: Optional[int] = None) -> int:
    """Pool page size: explicit > heuristic (clipped to the context, kept a
    multiple of 8)."""
    if page_size is not None:
        return int(page_size)
    return min(DEFAULT_PAGE_SIZE, max(8, -(-context_len // 8) * 8))


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Static pool geometry."""

    num_layers: int
    kv_heads: int
    head_dim: int
    num_pages: int                 # INCLUDING the null page 0
    page_size: int
    dtype: Any = torch.bfloat16    # pool dtype
    fp8: bool = False

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_torch_dtype(self.dtype))
        if self.fp8:
            raise NotImplementedError("fp8-KV pools are not ported yet "
                                      "(fp8 serve slice)")
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the "
                             "reserved null page)")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")


class CacheState(NamedTuple):
    """The two pools; updated in place by :func:`write_token` and
    :func:`write_prompt`."""

    k_pool: torch.Tensor
    v_pool: torch.Tensor


def init_cache(cfg: CacheConfig, *, device: DeviceLike = None) -> CacheState:
    shape = (cfg.num_layers, cfg.kv_heads, cfg.num_pages, cfg.page_size,
             cfg.head_dim)
    dev = resolve_device(device)
    return CacheState(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                      torch.zeros(shape, dtype=cfg.dtype, device=dev))


def write_token(cfg: CacheConfig, state: CacheState, layer: int, page_ids,
                slots, k_new, v_new) -> CacheState:
    """Write one decode token per batch slot into layer ``layer``, in place.

    ``page_ids``/``slots``: int [b] (masked slots carry page 0);
    ``k_new``/``v_new``: [b, kv_heads, d]. Returns ``state``.
    """
    # ``pool[layer]`` is a view [kv, pages, page, d]; the two index tensors
    # are adjacent advanced indices, so the selection is [kv, b, d] — the
    # JAX write puts b first because there the scalar layer index is
    # advanced too. Hence the transpose.
    idx = (slice(None), page_ids.long(), slots.long())
    state.k_pool[layer][idx] = k_new.transpose(0, 1).to(cfg.dtype)
    state.v_pool[layer][idx] = v_new.transpose(0, 1).to(cfg.dtype)
    return state


def write_prompt(cfg: CacheConfig, state: CacheState, layer: int,
                 block_table, length, k_seq, v_seq) -> CacheState:
    """Write a whole (padded) prompt's K/V for one sequence, in place.

    ``block_table``: int [m] (the sequence's pages); ``length``: the real
    prompt length — positions past it route to the null page;
    ``k_seq``/``v_seq``: [S, kv_heads, d]. Returns ``state``.
    """
    S = k_seq.shape[0]
    m = block_table.shape[0]
    pos = torch.arange(S, device=k_seq.device)
    live = pos < length
    # padded positions past the table clamp like an XLA gather, then route
    # to the null page
    pages = torch.where(live, block_table.long()[
        (pos // cfg.page_size).clamp(max=m - 1)], 0)
    slots = pos % cfg.page_size
    idx = (slice(None), pages, slots)
    state.k_pool[layer][idx] = k_seq.transpose(0, 1).to(cfg.dtype)
    state.v_pool[layer][idx] = v_seq.transpose(0, 1).to(cfg.dtype)
    return state
