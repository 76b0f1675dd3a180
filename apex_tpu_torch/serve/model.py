"""Serve-side GPT forward passes over the paged KV cache (``apex_tpu/serve/
model.py``).

Functions over the port's :class:`~apex_tpu_torch.models.gpt.GPT`
parameters, with the JAX serve path's rounding points:

- the embedding sum is ``(wte[ids] + wpe[pos])`` in fp32, then cast to
  ``cfg.dtype`` (as ``serve/model.py`` does, not ``GPT.__call__``);
- linears compute in the activation dtype with fp32 accumulation;
- LayerNorm takes fp32 statistics from fp32 params and outputs
  ``cfg.dtype``;
- GELU is the tanh approximation, in fp32;
- logits are the product ``x @ wte^T`` in ``cfg.dtype``, cast to fp32.

:func:`prefill_forward` runs one padded prompt through causal attention
(the flash kernel on CUDA) and writes every live position's K/V into the
sequence's pages; :func:`decode_forward` runs one token per batch slot,
writes its K/V and attends over the cache through the block table (the
paged decode kernel on CUDA). Both update the pool in place.

:func:`full_forward_logits` is the no-cache baseline; with
``reference=True`` it runs every kernel's plain version, on any device —
the oracle the kernels are held against on the card.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from apex_tpu_torch.models.gpt import GPT, GPTBlock, GPTConfig
from apex_tpu_torch.ops.flash_attention import (flash_attention,
                                                mha_reference,
                                                paged_decode_attention)
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine_reference
from apex_tpu_torch.serve import cache as cache_mod


def _split_qkv(cfg: GPTConfig, qkv: torch.Tensor):
    """[..., 3h] -> q, k, v [..., heads, d]: the GPT packing is per head
    ``[q|k|v]``, not ``[Q|K|V]`` across the width."""
    d = cfg.head_dim
    qkv = qkv.reshape(qkv.shape[:-1] + (cfg.num_heads, 3 * d))
    return qkv.split(d, dim=-1)


def _logits(params: GPT, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: ``x @ wte^T`` in the activation dtype, then fp32."""
    return params.wte.attend(x).float()


def _plain_ln(mod, x):
    return fused_layer_norm_affine_reference(x, mod.weight, mod.bias,
                                             mod.normalized_shape, mod.eps,
                                             mod.dtype)


def _kernel_ln(mod, x):
    return mod(x)


def _mlp(blk: GPTBlock, x: torch.Tensor) -> torch.Tensor:
    y = blk.mlp.fc1(x)
    y = F.gelu(y.float(), approximate="tanh").to(x.dtype)
    return blk.mlp.fc2(y)


def _block_forward(cfg: GPTConfig, blk: GPTBlock, x: torch.Tensor,
                   attend: Callable, ln: Callable = _kernel_ln):
    """One transformer block — the one copy of the serve-side block
    structure (decode, prefill and the no-cache baseline). ``attend(q, k,
    v)`` owns the cache interaction and returns the context in ``x``'s
    leading shape + ``[..., h]``."""
    h1 = ln(blk.ln1, x)
    q, k, v = _split_qkv(cfg, blk.attn.qkv(h1))
    ctx = attend(q, k, v)
    x = x + blk.attn.proj(ctx.to(cfg.dtype))
    h2 = ln(blk.ln2, x)
    return x + _mlp(blk, h2)


def decode_forward(cfg: GPTConfig, ccfg: cache_mod.CacheConfig, params: GPT,
                   state: cache_mod.CacheState, block_tables, positions,
                   tokens, active):
    """One decode step over a fixed-capacity batch.

    ``tokens``/``positions``/``active``: [B] (the token fed, its position
    in the sequence, whether the slot is live — inactive slots carry token
    0, position 0 and write to the null page). ``block_tables``: [B, m]
    int32. Returns ``(logits [B, V] f32, state)``; rows of inactive slots
    are garbage by contract. No operation mixes batch rows, so a slot's
    row depends on that slot's inputs alone — what makes decode-replay
    after a preemption bit-exact.
    """
    B = tokens.shape[0]
    x = params.wte(tokens)
    x = (x + params.wpe[positions]).to(cfg.dtype)
    seq_lens = torch.where(active, positions + 1, 0).to(torch.int32)
    rows = torch.arange(B, device=tokens.device)
    page_ids = torch.where(active,
                           block_tables[rows, positions // ccfg.page_size],
                           0)
    slots = torch.where(active, positions % ccfg.page_size, 0)
    for i in range(cfg.num_layers):
        def attend(q, k, v, *, _i=i):
            cache_mod.write_token(ccfg, state, _i, page_ids, slots, k, v)
            q4 = q[:, :, None, :].contiguous()        # [B, heads, 1, d]
            ctx = paged_decode_attention(q4, state.k_pool[_i],
                                         state.v_pool[_i], block_tables,
                                         seq_lens)
            return ctx[:, :, 0, :].reshape(B, -1)

        x = _block_forward(cfg, params.block(i), x, attend)
    x = params.ln_f(x)
    return _logits(params, x), state


def _causal_attend(q, k, v, d, sid, reference=False):
    """Causal attention over padded [b, S] token batches with padding
    segment ids — the attention of prefill and the no-cache baseline.
    Returns [b, S, heads, d]."""
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    attn = mha_reference if reference else flash_attention
    ctx = attn(qh, kh, vh, causal=True, scale=d ** -0.5, segment_ids_q=sid)
    return ctx.transpose(1, 2)


def prefill_forward(cfg: GPTConfig, ccfg: cache_mod.CacheConfig, params: GPT,
                    state: cache_mod.CacheState, block_table, length: int,
                    ids):
    """Full-prompt pass for ONE sequence, padded to the engine's static
    prompt length. ``ids``: [S] (anything past ``length``);
    ``block_table``: [m] int32. Writes every live position's K/V and
    returns ``(logits [V] f32 for position length-1, state)``."""
    S = ids.shape[0]
    d = cfg.head_dim
    x = params.wte(ids[None])
    x = (x + params.wpe[None, :S]).to(cfg.dtype)
    pos = torch.arange(S, device=ids.device)
    sid = torch.where(pos < length, 0, -1)[None].to(torch.int32)
    for i in range(cfg.num_layers):
        def attend(q, k, v, *, _i=i):
            cache_mod.write_prompt(ccfg, state, _i, block_table, length,
                                   k[0], v[0])
            return _causal_attend(q, k, v, d, sid).reshape(1, S, -1)

        x = _block_forward(cfg, params.block(i), x, attend)
    x = params.ln_f(x)
    return _logits(params, x[0, length - 1]), state


def full_forward_logits(cfg: GPTConfig, params: GPT, ids, lengths, *,
                        reference: bool = False):
    """The no-cache forward: causal attention over the whole padded
    context, logits at each row's last live position. ``ids``: [B, S],
    ``lengths``: [B]. ``reference=True`` runs the plain versions of the
    attention and LayerNorm kernels (on any device)."""
    B, S = ids.shape
    d = cfg.head_dim
    ln = _plain_ln if reference else _kernel_ln
    x = params.wte(ids)
    x = (x + params.wpe[None, :S]).to(cfg.dtype)
    pos = torch.arange(S, device=ids.device)
    sid = torch.where(pos[None, :] < lengths[:, None], 0, -1).to(torch.int32)
    for i in range(cfg.num_layers):
        def attend(q, k, v):
            return _causal_attend(q, k, v, d, sid,
                                  reference).reshape(B, S, -1)

        x = _block_forward(cfg, params.block(i), x, attend, ln)
    x = ln(params.ln_f, x)
    x_last = x[torch.arange(B, device=ids.device), lengths.long() - 1]
    return _logits(params, x_last)
