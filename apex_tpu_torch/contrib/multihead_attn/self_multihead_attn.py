"""Self multihead attention with an optional fused pre-LN residual add
(``apex_tpu/contrib/multihead_attn/self_multihead_attn.py``; apex's
``apex/contrib/multihead_attn/self_multihead_attn.py:26``).

``impl="fast"`` runs the port's flash attention: key padding as segment
ids, an additive ``attn_mask`` as the kernels' bias (B1's and B2's bias
variants on the card), ``attn_mask="causal"`` as the causal flag, and
attention dropout inside the kernels from a seed drawn on the host.
``impl="default"`` is the unfused composition (fp32 scores, -10000 fills,
softmax, plain dropout), as in the JAX module. ``include_norm_add`` puts
the port's LayerNorm (B6/B7 on the card) before the QKV product and adds
the residual after the output projection, with plain dropout on the
projection's output first (the reference's ``jit_dropout_add``).

Layout: inputs ``[seq, batch, embed]``. Parameters under the JAX module's
names and layouts (``qkv_weight`` [3e, e] or ``q_weight``/``k_weight``/
``v_weight`` [e, e], ``qkv_bias``, ``out_proj_weight`` [e, e],
``out_proj_bias``, ``lyr_nrm_gamma_weights``, ``lyr_nrm_beta_weights``), so
:meth:`SelfMultiheadAttn.params_from_jax` carries a flax tree across.

Training: ``is_training=True`` (or ``deterministic=False``) with
``dropout > 0`` takes a host ``torch.Generator`` (``generator=``) in place
of the JAX module's ``dropout`` rng: the attention seed is drawn from it,
and the plain dropout masks come from a device generator seeded from it.
``reference=True`` runs the plain version of every kernel (flash
attention, LayerNorm), differentiated by autograd, with the same seeds and
masks: the oracle the kernels are held against on the card.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from apex_tpu_torch._compat import DeviceLike, as_torch_dtype, resolve_device
from apex_tpu_torch.contrib.multihead_attn._fused_prep import (
    default_attention, dropout, dropout_rngs, fast_attention, heads,
    layer_norm, lecun_normal_, load_flax_params, prep_fast_path)


class SelfMultiheadAttn(nn.Module):
    """``SelfMultiheadAttn(embed_dim, num_heads, dropout, use_bias,
    include_norm_add, separate_qkv_params, impl)`` with parameters of
    ``dtype`` on ``device`` (CUDA by default), drawn from the flax
    initialisers' distributions (``lecun_normal`` weights, zero biases,
    unit LayerNorm gains) with ``generator`` (module docstring)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 use_bias: bool = False, include_norm_add: bool = False,
                 separate_qkv_params: bool = False, impl: str = "fast", *,
                 dtype=torch.float32, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        if impl not in ("fast", "default"):
            raise ValueError(f"impl must be 'fast' or 'default', got {impl!r}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.use_bias = float(dropout), use_bias
        self.include_norm_add = include_norm_add
        self.separate_qkv_params, self.impl = separate_qkv_params, impl
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
        if separate_qkv_params:
            self.q_weight, self.k_weight, self.v_weight = (
                param(e, e) for _ in range(3))
        else:
            self.qkv_weight = param(3 * e, e)
            if use_bias:
                self.qkv_bias = param(3 * e, fill=0.0)
        self.out_proj_weight = param(e, e)
        if use_bias:
            self.out_proj_bias = param(e, fill=0.0)

    @classmethod
    def params_from_jax(cls, embed_dim: int, num_heads: int,
                        params: Mapping, *, device: DeviceLike = None,
                        **kwargs) -> "SelfMultiheadAttn":
        """The module with the JAX module's parameters (its flax
        ``params`` dict of numpy arrays); ``kwargs`` are the constructor's
        options, which must match the JAX module's."""
        return load_flax_params(
            cls(embed_dim, num_heads, device=device, **kwargs), params)

    def forward(self, query, key=None, value=None, key_padding_mask=None,
                attn_mask=None, is_training: bool = True,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                reference: bool = False):
        """``query`` [s, b, e] -> [s, b, e] (``key``/``value`` are ignored:
        self-attention). ``key_padding_mask`` [b, s], true at padding;
        ``attn_mask`` an additive [s, s] or [b|1, h|1, s, s] mask, or the
        string ``"causal"``."""
        deterministic = (not is_training) if deterministic is None \
            else deterministic
        e, h = self.embed_dim, self.num_heads
        d = e // h
        s, b, _ = query.shape
        rngs = dropout_rngs(self.dropout, deterministic, generator,
                            query.device)
        residual = x = query
        if self.include_norm_add:
            x = layer_norm(x, self.lyr_nrm_gamma_weights,
                           self.lyr_nrm_beta_weights, reference)
        if self.separate_qkv_params:
            q, k, v = (x @ w.t().to(x.dtype) for w in (
                self.q_weight, self.k_weight, self.v_weight))
        else:
            qkv = x @ self.qkv_weight.t().to(x.dtype)
            if self.use_bias:
                qkv = qkv + self.qkv_bias.to(qkv.dtype)
            q, k, v = qkv.split(e, dim=-1)
        qh, kh, vh = (heads(t, s, b, h) for t in (q, k, v))
        scale = d ** -0.5
        causal = isinstance(attn_mask, str) and attn_mask == "causal"
        if self.impl == "fast":
            sid_q, sid_kv, bias, rate, seed = prep_fast_path(
                key_padding_mask, attn_mask, b, s, self.dropout,
                deterministic, rngs and rngs[0], causal=causal)
            ctx = fast_attention(qh, kh, vh, scale, causal, sid_q, sid_kv,
                                 bias, rate, seed, reference)
        else:
            ctx = default_attention(qh, kh, vh, scale, causal,
                                    None if causal else attn_mask,
                                    key_padding_mask, self.dropout, rngs)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, e)
        out = ctx @ self.out_proj_weight.t().to(ctx.dtype)
        if self.use_bias:
            out = out + self.out_proj_bias.to(out.dtype)
        if self.include_norm_add:
            if rngs is not None:
                out = dropout(out, self.dropout, rngs[1])
            out = out + residual
        return out
