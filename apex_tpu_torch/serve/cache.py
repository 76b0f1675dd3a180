"""Paged KV cache of the port (``apex_tpu/serve/cache.py``): a preallocated
page pool plus per-sequence block tables.

The pool is allocated once (:func:`init_cache`) and never reshaped. Every
cache mutation writes into it in place — the JAX package donates the pool
through each jitted step for the same effect — so one pool is resident,
never two. Layout (the ``ops.flash_attention.paged_decode_attention``
contract)::

    k_pool / v_pool   [num_layers, kv_heads, num_pages, page_size, d]
    k_scale / v_scale [num_layers, kv_heads, num_pages]  fp32 (fp8 mode)

Page 0 is the null page: the host allocator never hands it out, and every
masked write (inactive batch slots, prompt padding) is routed to it, so a
scatter needs no branch and nothing ever reads the null page as live.
Several masked writes of one call may land on the same null-page cell (or
null-page scale); which one wins does not matter. Live pages never repeat
an index within one call.

fp8-KV mode stores e4m3 pages through the ``amp.fp8`` codec with one scale
per (layer, head, page), fixed when the page's slot-0 token is written
(``compute_scale`` of that token's amax with ``fp8_margin`` powers of two
of headroom); later tokens of the page quantize with the same scale and
saturate past it. The slot-0 rule makes evict/re-admit bit-exact: a page's
scale is a function of its first token alone, whether that token came by
prefill or by decode.

Page size resolves explicit > heuristic; the JAX package's tuned cache
between the two is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from apex_tpu_torch._compat import DeviceLike, as_torch_dtype, resolve_device
from apex_tpu_torch.amp import fp8 as fp8_mod

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
    dtype: Any = torch.bfloat16    # pool dtype (ignored when fp8)
    fp8: bool = False
    fp8_margin: float = 2.0        # 2**margin headroom over the slot-0 amax

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_torch_dtype(self.dtype))
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the "
                             "reserved null page)")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")

    @property
    def pool_dtype(self) -> torch.dtype:
        return fp8_mod.E4M3 if self.fp8 else self.dtype

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    def pages_for_tokens(self, n: int) -> int:
        return -(-int(n) // self.page_size)

    # -- capacity accounting (host-side ints) ------------------------------

    def bytes_per_page(self) -> int:
        """Device bytes one pool page costs across k + v (+ fp8 scales),
        over all layers."""
        elems = self.kv_heads * self.page_size * self.head_dim
        per = 2 * elems * self.pool_dtype.itemsize
        if self.fp8:
            per += 2 * self.kv_heads * 4          # k_scale + v_scale rows
        return per * self.num_layers

    def pool_bytes(self) -> int:
        return self.bytes_per_page() * self.num_pages

    def pages_in_budget(self, budget_bytes: int) -> int:
        return int(budget_bytes) // self.bytes_per_page()

    def max_concurrent_seqs(self, budget_bytes: int, seq_len: int) -> int:
        """How many ``seq_len``-token sequences fit a pool of
        ``budget_bytes`` (minus the null page)."""
        usable = max(0, self.pages_in_budget(budget_bytes) - 1)
        return usable // self.pages_for_tokens(seq_len)

    def occupancy_bytes(self, pages_in_use: int) -> int:
        """Device bytes held by ``pages_in_use`` allocated pages (the same
        accounting as :meth:`bytes_per_page`)."""
        return int(pages_in_use) * self.bytes_per_page()


class CacheState(NamedTuple):
    """The pools (and, in fp8 mode, their per-page scales); updated in
    place by :func:`write_token` and :func:`write_prompt`."""

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    k_scale: Optional[torch.Tensor] = None   # None outside fp8 mode
    v_scale: Optional[torch.Tensor] = None


def init_cache(cfg: CacheConfig, *, device: DeviceLike = None) -> CacheState:
    shape = (cfg.num_layers, cfg.kv_heads, cfg.num_pages, cfg.page_size,
             cfg.head_dim)
    dev = resolve_device(device)
    k = torch.zeros(shape, dtype=cfg.pool_dtype, device=dev)
    v = torch.zeros(shape, dtype=cfg.pool_dtype, device=dev)
    if not cfg.fp8:
        return CacheState(k, v)
    # scales start at 1.0: finite and positive everywhere, so the dequant
    # divides are safe even for never-written pages; two distinct tensors,
    # since each is written in place on its own
    sshape = (cfg.num_layers, cfg.kv_heads, cfg.num_pages)
    return CacheState(k, v,
                      torch.ones(sshape, dtype=torch.float32, device=dev),
                      torch.ones(sshape, dtype=torch.float32, device=dev))


def _page_scales(cfg: CacheConfig, x: torch.Tensor) -> torch.Tensor:
    """``compute_scale`` over the head dim: ``x`` [..., kv, d] ->
    [..., kv]."""
    amax = x.float().abs().amax(dim=-1)
    return fp8_mod.compute_scale(amax, fp8_mod.E4M3_MAX,
                                 margin=cfg.fp8_margin)


def _store(cfg: CacheConfig, state: CacheState, layer: int, pages, slots,
           k_t, v_t) -> None:
    """Scatter [n, kv, d] rows into the pools of ``layer`` at (page, slot).

    ``pool[layer]`` is a view [kv, pages, page, d]; the two index tensors
    are adjacent advanced indices, so the selection is [kv, n, d] — the JAX
    write puts n first because there the scalar layer index is advanced
    too. Hence the transpose."""
    idx = (slice(None), pages, slots)
    state.k_pool[layer][idx] = k_t.transpose(0, 1).to(cfg.pool_dtype)
    state.v_pool[layer][idx] = v_t.transpose(0, 1).to(cfg.pool_dtype)


def write_token(cfg: CacheConfig, state: CacheState, layer: int, page_ids,
                slots, k_new, v_new) -> CacheState:
    """Write one decode token per batch slot into layer ``layer``, in place.

    ``page_ids``/``slots``: int [b] (masked slots carry page 0);
    ``k_new``/``v_new``: [b, kv_heads, d]. Returns ``state``. In fp8 mode
    a token in slot 0 sets its page's scale; any other token quantizes with
    the scale its page already has.
    """
    page_ids, slots = page_ids.long(), slots.long()
    if cfg.fp8:
        first = (slots == 0)[:, None]                       # [b, 1]
        scales = []
        for pool_scale, x in ((state.k_scale, k_new), (state.v_scale, v_new)):
            # the torch selection [kv, b] is the JAX [b, kv] transposed (the
            # same advanced-indexing shape rule as the pools)
            cur = pool_scale[layer][:, page_ids].t()        # [b, kv]
            s = torch.where(first, _page_scales(cfg, x), cur)
            pool_scale[layer][:, page_ids] = s.t()
            scales.append(s[..., None])
        k_new = fp8_mod.quantize(k_new, scales[0], fp8_mod.E4M3)
        v_new = fp8_mod.quantize(v_new, scales[1], fp8_mod.E4M3)
    _store(cfg, state, layer, page_ids, slots, k_new, v_new)
    return state


def write_prompt(cfg: CacheConfig, state: CacheState, layer: int,
                 block_table, length, k_seq, v_seq) -> CacheState:
    """Write a whole (padded) prompt's K/V for one sequence, in place.

    ``block_table``: int [m] (the sequence's pages); ``length``: the real
    prompt length — positions past it route to the null page;
    ``k_seq``/``v_seq``: [S, kv_heads, d]. Returns ``state``. In fp8 mode
    each touched page's scale comes from its slot-0 position, as the decode
    write would have set it, and every position quantizes with its page's
    new scale.
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
    if cfg.fp8:
        pos0 = torch.arange(0, S, cfg.page_size, device=k_seq.device)
        pages0 = pages[pos0]                          # masked ones hit null
        scales = []
        for pool_scale, x in ((state.k_scale, k_seq), (state.v_scale, v_seq)):
            pool_scale[layer][:, pages0] = _page_scales(cfg, x[pos0]).t()
            scales.append(pool_scale[layer][:, pages].t()[..., None])
        k_seq = fp8_mod.quantize(k_seq, scales[0], fp8_mod.E4M3)
        v_seq = fp8_mod.quantize(v_seq, scales[1], fp8_mod.E4M3)
    _store(cfg, state, layer, pages, slots, k_seq, v_seq)
    return state
