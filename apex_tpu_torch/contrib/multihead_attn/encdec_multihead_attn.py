"""Encoder-decoder (cross) multihead attention
(``apex_tpu/contrib/multihead_attn/encdec_multihead_attn.py``; apex's
``apex/contrib/multihead_attn/encdec_multihead_attn.py``).

Q from the decoder stream ``query`` [sq, b, e], K and V from the encoder
stream ``key`` [sk, b, e] through one fused KV product; the same options
and fast path as :class:`~apex_tpu_torch.contrib.multihead_attn.
SelfMultiheadAttn` (key padding as segment ids over the encoder's keys,
an additive ``attn_mask`` [sq, sk] or [b|1, h|1, sq, sk] as the kernels'
bias, sq != sk), parameters ``q_weight`` [e, e], ``kv_weight`` [2e, e],
``out_proj_weight``, ``out_proj_bias`` and the LayerNorm's, as in the JAX
module.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from apex_tpu_torch._compat import DeviceLike, as_torch_dtype, resolve_device
from apex_tpu_torch.contrib.multihead_attn._fused_prep import (
    default_attention, dropout, dropout_rngs, fast_attention, heads,
    layer_norm, lecun_normal_, load_flax_params, prep_fast_path)


class EncdecMultiheadAttn(nn.Module):
    """``EncdecMultiheadAttn(embed_dim, num_heads, dropout, use_bias,
    include_norm_add, impl)`` with parameters of ``dtype`` on ``device``
    (CUDA by default), initialised as
    :class:`~apex_tpu_torch.contrib.multihead_attn.SelfMultiheadAttn`'s."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 use_bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast", *, dtype=torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        if impl not in ("fast", "default"):
            raise ValueError(f"impl must be 'fast' or 'default', got {impl!r}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.use_bias = float(dropout), use_bias
        self.include_norm_add, self.impl = include_norm_add, impl
        e, dev, dt = embed_dim, resolve_device(device), as_torch_dtype(dtype)

        def param(*shape, fill=None):
            p = nn.Parameter(torch.empty(shape, dtype=dt, device=dev))
            if fill is None:
                lecun_normal_(p, generator)
            else:
                nn.init.constant_(p, fill)
            return p

        if include_norm_add:
            self.lyr_nrm_gamma_weights = param(e, fill=1.0)
            self.lyr_nrm_beta_weights = param(e, fill=0.0)
        self.q_weight = param(e, e)
        self.kv_weight = param(2 * e, e)
        self.out_proj_weight = param(e, e)
        if use_bias:
            self.out_proj_bias = param(e, fill=0.0)

    @classmethod
    def params_from_jax(cls, embed_dim: int, num_heads: int,
                        params: Mapping, *, device: DeviceLike = None,
                        **kwargs) -> "EncdecMultiheadAttn":
        """The module with the JAX module's parameters (its flax
        ``params`` dict of numpy arrays); ``kwargs`` are the constructor's
        options, which must match the JAX module's."""
        return load_flax_params(
            cls(embed_dim, num_heads, device=device, **kwargs), params)

    def forward(self, query, key, value=None, key_padding_mask=None,
                attn_mask=None, is_training: bool = True,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                reference: bool = False):
        """``query`` [sq, b, e] and ``key`` [sk, b, e] (``value`` is
        ignored: K and V both come from ``key``) -> [sq, b, e].
        ``key_padding_mask`` [b, sk], true at padding; ``attn_mask`` an
        additive [sq, sk] or [b|1, h|1, sq, sk] mask. ``generator`` and
        ``reference`` as :class:`SelfMultiheadAttn`'s."""
        deterministic = (not is_training) if deterministic is None \
            else deterministic
        e, h = self.embed_dim, self.num_heads
        d = e // h
        sq, b, _ = query.shape
        sk = key.shape[0]
        rngs = dropout_rngs(self.dropout, deterministic, generator,
                            query.device)
        residual = x = query
        if self.include_norm_add:
            x = layer_norm(x, self.lyr_nrm_gamma_weights,
                           self.lyr_nrm_beta_weights, reference)
        q = x @ self.q_weight.t().to(x.dtype)
        k, v = (key @ self.kv_weight.t().to(key.dtype)).split(e, dim=-1)
        qh, kh, vh = heads(q, sq, b, h), heads(k, sk, b, h), heads(v, sk, b, h)
        scale = d ** -0.5
        if self.impl == "fast":
            sid_q, sid_kv, bias, rate, seed = prep_fast_path(
                key_padding_mask, attn_mask, b, sq, self.dropout,
                deterministic, rngs and rngs[0])
            ctx = fast_attention(qh, kh, vh, scale, False, sid_q, sid_kv,
                                 bias, rate, seed, reference)
        else:
            ctx = default_attention(qh, kh, vh, scale, False, attn_mask,
                                    key_padding_mask, self.dropout, rngs)
        ctx = ctx.permute(2, 0, 1, 3).reshape(sq, b, e)
        out = ctx @ self.out_proj_weight.t().to(ctx.dtype)
        if self.use_bias:
            out = out + self.out_proj_bias.to(out.dtype)
        if self.include_norm_add:
            if rngs is not None:
                out = dropout(out, self.dropout, rngs[1])
            out = out + residual
        return out
