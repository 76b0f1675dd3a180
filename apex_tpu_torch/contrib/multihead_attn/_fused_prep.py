"""The fast path's operands for the multihead attention modules
(``apex_tpu/contrib/multihead_attn/_fused_prep.py``): masks and dropout
arguments turned into flash attention's, and the modules' shared plumbing
(parameter initialisation, the generators of a training forward, plain
dropout, loading a flax tree)."""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from apex_tpu_torch._compat import as_torch_dtype
from apex_tpu_torch.ops.flash_attention import flash_attention, mha_reference
from apex_tpu_torch.ops.layer_norm import (fused_layer_norm_affine,
                                           fused_layer_norm_affine_reference)


def prep_fast_path(key_padding_mask, attn_mask, b: int, sq: int,
                   dropout: float, deterministic: bool,
                   generator: Optional[torch.Generator], *,
                   causal: bool = False):
    """``(sid_q, sid_kv, bias, dropout_rate, dropout_seed)`` for
    :func:`~apex_tpu_torch.ops.flash_attention.flash_attention`.

    - ``key_padding_mask`` [b, sk] (true = pad) becomes segment ids: -1 at
      the pads of ``sid_kv``, 0 elsewhere and in every ``sid_q`` row;
    - an additive ``attn_mask`` becomes the bias: [sq, sk] (the reference
      layout) as [1, 1, sq, sk], or an explicit [b|1, h|1, sq, sk]; a 3-D
      mask is ambiguous (per batch or per head) and raises, as in JAX;
      with ``causal`` (``attn_mask="causal"``) there is no bias;
    - the dropout seed, an int32 in [0, 2^31 - 1), is drawn on the host
      from ``generator`` (the JAX module's ``make_rng("dropout")``), at
      rate ``dropout`` when not ``deterministic``.
    """
    sid_q = sid_kv = None
    if key_padding_mask is not None:
        sid_kv = torch.where(key_padding_mask.bool(), -1, 0).to(torch.int32)
        sid_q = torch.zeros((b, sq), dtype=torch.int32,
                            device=key_padding_mask.device)
    bias = None
    if attn_mask is not None and not causal:
        bias = attn_mask
        if bias.dim() == 2:             # [sq, sk], the reference layout
            bias = bias[None, None]
        elif bias.dim() != 4:
            raise ValueError(
                "attn_mask must be [sq, sk] (reference layout) or an "
                f"explicit [b|1, h|1, sq, sk]; got {tuple(bias.shape)} — "
                "3-D masks are ambiguous (per-batch vs per-head)")
    drop = dropout if (dropout > 0 and not deterministic) else 0.0
    seed = None
    if drop > 0.0:
        seed = int(torch.randint(0, 2 ** 31 - 1, (),
                                 generator=_host(generator)))
    return sid_q, sid_kv, bias, drop, seed


def _host(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None or generator.device.type != "cpu":
        raise ValueError(
            "multihead_attn: a training forward with dropout needs a host "
            "(CPU) torch.Generator (its draws never wait for the device)")
    return generator


def dropout_rngs(dropout: float, deterministic: bool,
                 generator: Optional[torch.Generator], device):
    """``(host generator, device generator)`` of a training forward with
    dropout, or None (deterministic, or rate 0): the attention seeds come
    from the host generator, the plain dropout masks from a device
    generator seeded from it first."""
    if deterministic or dropout == 0.0:
        return None
    host = _host(generator)
    dev = torch.Generator(device=device)
    dev.manual_seed(int(torch.randint(0, 2 ** 62, (), generator=host)))
    return host, dev


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator):
    """flax's ``Dropout`` in plain PyTorch: kept elements ``x / (1 -
    rate)`` in ``x``'s dtype, the rest 0, each kept with probability
    ``1 - rate`` (a mask from ``gen``; flax's bernoulli stream is not
    reproduced)."""
    keep = torch.rand(x.shape, generator=gen, device=gen.device) \
        .to(x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def lecun_normal_(p: torch.Tensor, generator=None) -> None:
    """flax's ``lecun_normal`` on a parameter of shape [rows, cols], whose
    first axis flax reads as fan-in (``in_axis=-2``): a normal truncated at
    two standard deviations with variance ``1 / rows``, drawn on the CPU
    from ``generator`` and copied."""
    std = math.sqrt(1.0 / p.shape[0]) / .87962566103423978
    cpu = torch.empty(p.shape, dtype=torch.float32)
    nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    with torch.no_grad():
        p.copy_(cpu)


def load_flax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """The module's parameters from a flax parameter dict of the JAX module
    (numpy arrays under the same names, as ``jax.device_get`` gives them);
    each leaf keeps its dtype."""
    names = dict(module.named_parameters())
    if set(params) != set(names):
        raise ValueError(
            f"{type(module).__name__}: JAX params do not match: missing "
            f"{sorted(set(names) - set(params))}, unexpected "
            f"{sorted(set(params) - set(names))}")
    for name, p in names.items():
        arr = np.asarray(params[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} != "
                             f"{tuple(p.shape)}")
        p.data = torch.from_numpy(np.array(arr, np.float32)).to(
            device=p.device, dtype=as_torch_dtype(arr.dtype))
    return module


def heads(t: torch.Tensor, s: int, b: int, h: int) -> torch.Tensor:
    """[s, b, h d] -> [b, h, s, d], contiguous."""
    return t.reshape(s, b, h, -1).permute(1, 2, 0, 3).contiguous()


def default_attention(qh, kh, vh, scale: float, causal: bool, attn_mask,
                      key_padding_mask, rate: float,
                      rngs: Optional[Tuple]) -> torch.Tensor:
    """The ``impl="default"`` composition (the JAX modules' unfused
    branch): fp32 scores, -10000 fills for the causal mask and key
    padding, the additive ``attn_mask``, softmax, plain dropout on the
    probabilities, the context in q's dtype."""
    scores = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * scale
    sq, sk = scores.shape[-2:]
    if causal:
        cm = (torch.arange(sk, device=qh.device)[None, :]
              > torch.arange(sq, device=qh.device)[:, None])
        scores = torch.where(cm, -10000.0, scores)
    elif attn_mask is not None:
        scores = scores + attn_mask.float()
    if key_padding_mask is not None:
        scores = torch.where(key_padding_mask.bool()[:, None, None, :],
                             -10000.0, scores)
    probs = torch.softmax(scores, dim=-1)
    if rngs is not None and rate > 0:
        probs = dropout(probs, rate, rngs[1])
    return torch.einsum("bhqk,bhkd->bhqd", probs, vh.float()).to(qh.dtype)


def layer_norm(x, gamma, beta, reference: bool):
    """The pre-LN of the norm_add variants: the JAX module's
    ``fused_layer_norm_affine(x, gamma.astype(x.dtype), beta.astype(
    x.dtype), (e,))``, through the kernels or their plain version."""
    ln = fused_layer_norm_affine_reference if reference \
        else fused_layer_norm_affine
    return ln(x, gamma.to(x.dtype), beta.to(x.dtype), (x.shape[-1],))


def fast_attention(qh, kh, vh, scale, causal, sid_q, sid_kv, bias, rate,
                   seed, reference: bool):
    """The ``impl="fast"`` attention over :func:`prep_fast_path`'s
    operands: flash attention (its kernels on the card), or with
    ``reference`` its plain version."""
    attend = mha_reference if reference else flash_attention
    return attend(qh, kh, vh, causal=causal, segment_ids_q=sid_q,
                  segment_ids_kv=sid_kv, scale=scale, bias=bias,
                  dropout_rate=rate, dropout_seed=seed)
