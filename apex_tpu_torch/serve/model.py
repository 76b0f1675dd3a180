"""Serve-side GPT forward passes over the paged KV cache (``apex_tpu/serve/
model.py``).

Functions over the port's :class:`~apex_tpu_torch.models.gpt.GPT`
parameters, with the JAX serve path's rounding points:

- the embedding sum is ``(wte[ids] + wpe[pos])`` in fp32, then cast to
  ``cfg.dtype`` (as ``serve/model.py`` does, not ``GPT.__call__``);
- linears compute in the activation dtype with fp32 accumulation; a
  linear quantized by :func:`quantize_gpt_weights` streams its e4m3 kernel
  through the fp8 dequant-matmul (the CUDA kernel on the card) and adds
  its bias in the output dtype, as the JAX ``_linear`` does;
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

Every function takes the parameters as a :class:`~apex_tpu_torch.models.
gpt.GPT` or a :class:`ServeParams` (the view :func:`quantize_gpt_weights`
and the speculative draft build): both give ``wte``, ``wpe``, ``ln_f``,
``block(i)`` and ``device``.
"""

from __future__ import annotations

import types
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch.models.gpt import GPTConfig
from apex_tpu_torch.ops.flash_attention import (flash_attention,
                                                mha_reference,
                                                paged_decode_attention)
from apex_tpu_torch.ops.fp8_matmul import (fp8_dequant_matmul,
                                           fp8_dequant_matmul_reference,
                                           quantize_weight)
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine_reference
from apex_tpu_torch.serve import cache as cache_mod

#: the block linears that fp8 weight streaming quantizes
_FP8_WEIGHT_LINEARS = (("attn", "qkv"), ("attn", "proj"),
                       ("mlp", "fc1"), ("mlp", "fc2"))


class Fp8Linear:
    """A block linear streamed as e4m3: ``kernel`` [in, out] e4m3,
    ``scale`` a 0-d fp32 tensor, ``bias`` the original layer's bias (the
    same tensor, not a copy)."""

    def __init__(self, kernel: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor]):
        self.kernel, self.scale, self.bias = kernel, scale, bias


class ServeParams:
    """The parameters a serve forward reads, without the training module
    around them: the shared ``wte``/``wpe``/``ln_f`` and a list of blocks,
    each exposing ``ln1``, ``attn.qkv``, ``attn.proj``, ``ln2``,
    ``mlp.fc1`` and ``mlp.fc2`` as a GPT block does. Nothing is copied:
    every tensor and module is the one it was built from."""

    def __init__(self, wte, wpe, ln_f, blocks: List):
        self.wte, self.wpe, self.ln_f = wte, wpe, ln_f
        self.blocks = list(blocks)

    def block(self, i: int):
        return self.blocks[i]

    @property
    def device(self) -> torch.device:
        return self.wpe.device


def quantize_gpt_weights(cfg: GPTConfig, params, *,
                         margin: float = 0.0) -> ServeParams:
    """Per-tensor e4m3 quantization of every block linear kernel (qkv,
    proj, fc1, fc2), each with one fp32 scale
    (:func:`~apex_tpu_torch.ops.fp8_matmul.quantize_weight`). Embeddings,
    positions, norms and biases stay as they are and are shared, not
    copied. ``params`` is left unchanged; the returned view serves through
    the same forwards. Runs once, at engine build."""
    blocks = []
    for i in range(cfg.num_layers):
        blk = params.block(i)
        groups = {}
        for group, name in _FP8_WEIGHT_LINEARS:
            lin = getattr(getattr(blk, group), name)
            q, scale = quantize_weight(lin.kernel.detach(), margin=margin)
            groups.setdefault(group, {})[name] = Fp8Linear(q, scale, lin.bias)
        blocks.append(types.SimpleNamespace(
            ln1=blk.ln1, ln2=blk.ln2,
            **{g: types.SimpleNamespace(**lins) for g, lins in groups.items()}))
    return ServeParams(params.wte, params.wpe, params.ln_f, blocks)


def weight_stream_bytes(cfg: GPTConfig, params) -> int:
    """Device bytes of the block linear weights one decode step streams
    (kernels, plus the fp8 scales; biases and norms left out on both sides,
    so the fp8-against-bf16 ratio measures what quantization changed)."""
    total = 0
    for i in range(cfg.num_layers):
        blk = params.block(i)
        for group, name in _FP8_WEIGHT_LINEARS:
            lin = getattr(getattr(blk, group), name)
            total += lin.kernel.numel() * lin.kernel.element_size()
            if isinstance(lin, Fp8Linear):
                total += lin.scale.numel() * lin.scale.element_size()
    return int(total)


def _linear(lin, x: torch.Tensor, reference: bool = False) -> torch.Tensor:
    """One block linear. A quantized one streams its e4m3 kernel through
    the fp8 dequant-matmul (its plain version with ``reference``), then
    adds the bias in the output dtype; any other is the layer module."""
    if not isinstance(lin, Fp8Linear):
        return lin(x)
    mm = fp8_dequant_matmul_reference if reference else fp8_dequant_matmul
    y = mm(x, lin.kernel, lin.scale, x.dtype)
    if lin.bias is not None:
        y = y + lin.bias.to(y.dtype)
    return y


def _split_qkv(cfg: GPTConfig, qkv: torch.Tensor):
    """[..., 3h] -> q, k, v [..., heads, d]: the GPT packing is per head
    ``[q|k|v]``, not ``[Q|K|V]`` across the width."""
    d = cfg.head_dim
    qkv = qkv.reshape(qkv.shape[:-1] + (cfg.num_heads, 3 * d))
    return qkv.split(d, dim=-1)


def _logits(params, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: ``x @ wte^T`` in the activation dtype, then fp32."""
    return params.wte.attend(x).float()


def _plain_ln(mod, x):
    return fused_layer_norm_affine_reference(x, mod.weight, mod.bias,
                                             mod.normalized_shape, mod.eps,
                                             mod.dtype)


def _kernel_ln(mod, x):
    return mod(x)


def _mlp(blk, x: torch.Tensor, reference: bool) -> torch.Tensor:
    y = _linear(blk.mlp.fc1, x, reference)
    y = F.gelu(y.float(), approximate="tanh").to(x.dtype)
    return _linear(blk.mlp.fc2, y, reference)


def _block_forward(cfg: GPTConfig, blk, x: torch.Tensor, attend: Callable,
                   reference: bool = False):
    """One transformer block — the one copy of the serve-side block
    structure (decode, prefill and the no-cache baseline). ``attend(q, k,
    v)`` owns the cache interaction and returns the context in ``x``'s
    leading shape + ``[..., h]``. ``reference`` takes the plain versions of
    the LayerNorm and fp8 dequant-matmul kernels."""
    ln = _plain_ln if reference else _kernel_ln
    h1 = ln(blk.ln1, x)
    q, k, v = _split_qkv(cfg, _linear(blk.attn.qkv, h1, reference))
    ctx = attend(q, k, v)
    x = x + _linear(blk.attn.proj, ctx.to(cfg.dtype), reference)
    h2 = ln(blk.ln2, x)
    return x + _mlp(blk, h2, reference)


def decode_forward(cfg: GPTConfig, ccfg: cache_mod.CacheConfig, params,
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
            scales = {}
            if ccfg.fp8:
                scales = dict(k_scales=state.k_scale[_i],
                              v_scales=state.v_scale[_i])
            ctx = paged_decode_attention(q4, state.k_pool[_i],
                                         state.v_pool[_i], block_tables,
                                         seq_lens, **scales)
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


def prefill_forward(cfg: GPTConfig, ccfg: cache_mod.CacheConfig, params,
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


def full_forward_logits(cfg: GPTConfig, params, ids, lengths, *,
                        reference: bool = False):
    """The no-cache forward: causal attention over the whole padded
    context, logits at each row's last live position. ``ids``: [B, S],
    ``lengths``: [B]. ``reference=True`` runs the plain versions of the
    attention, LayerNorm and fp8 dequant-matmul kernels (on any
    device)."""
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

        x = _block_forward(cfg, params.block(i), x, attend, reference)
    x = ln(params.ln_f, x)
    x_last = x[torch.arange(B, device=ids.device), lengths.long() - 1]
    return _logits(params, x_last)
