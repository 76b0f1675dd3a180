"""GPT configuration and parameters of the port (``apex_tpu/models/gpt.py``).

:class:`GPT` holds the parameters of the JAX package's GPT under the same
names and layouts as its flax tree — ``wte.embedding`` [V, h], ``wpe``
[max_seq_len, h], ``block_{i}.{ln1, attn.qkv, attn.proj, ln2, mlp.fc1,
mlp.fc2}`` with linear ``kernel`` [in, out] and ``bias`` [out], ``ln_f``
— so :meth:`GPT.params_from_jax` carries a trained or flax-initialised tree
across leaf for leaf, and the serve forward (``apex_tpu_torch.serve.
model``) reads them as the JAX serve path does. The qkv projection packs
each head as ``[q|k|v]`` (``serve.model._split_qkv``).

:meth:`GPT.init_params` draws from the flax initialisers' distributions:
``normal(0.02)`` for ``wte``/``wpe``, ``lecun_normal`` (truncated normal at
two standard deviations, variance ``1/fan_in``) for linear kernels, zeros
for biases, ones/zeros for LayerNorm. The numbers differ from a flax init
with the same seed; tests carry flax params across instead.

:meth:`GPT.forward` and :meth:`GPT.loss` are the training forward and loss
of the JAX ``GPT.__call__``/``GPT.loss`` (``apex_tpu/models/gpt.py:337-433``),
with its rounding points: the embedding is ``wte[ids]`` and ``wpe[:s]``
each cast to ``cfg.dtype`` and added in that dtype; residual adds are in
``cfg.dtype``; GELU is the tanh form in fp32; the qkv split is per head;
attention is causal flash attention with scale ``d ** -0.5``; the loss is
the mean over all tokens of the fused LM-head cross entropy (or, with
``fused_lm_head=False``, of the vocab-parallel cross entropy over
materialized logits). ``reference=True`` runs the plain version of every
kernel — differentiated by autograd — on any device: the oracle the
kernels are held against on the card. The serve path
(``apex_tpu_torch.serve``) runs its forwards under ``torch.no_grad()``.

Training mode: ``deterministic=False`` with a host ``torch.Generator``
takes the place of the JAX ``apply(..., deterministic=False,
rngs={"dropout": key})``, with Megatron's dropout knobs
(``attention_dropout``, ``hidden_dropout``). Attention dropout runs inside
the flash kernels from a per-layer int32 seed drawn from the generator on
the host (the JAX model's ``randint(0, 2**30 - 1)`` plus the tensor-parallel
rank, 0 at the port's tp = 1), so no draw waits for the device; hidden
dropout drops each residual branch's output with a plain torch mask from a
device generator seeded from the same host generator (flax's bernoulli
stream is not reproduced). ``deterministic=True``, the default, runs no
dropout, as the JAX ``GPT.loss`` does.

Not ported yet (raise ``NotImplementedError``): ``remat_blocks``,
``attention_impl="fused_softmax"``, mixture-of-experts and sequence
parallelism.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._compat import DeviceLike, as_torch_dtype, resolve_device
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.flash_attention import flash_attention, mha_reference
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine_reference
from apex_tpu_torch.ops.lm_head_ce import (fused_lm_head_cross_entropy,
                                           lm_head_cross_entropy_reference)
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    vocab_parallel_cross_entropy)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    max_seq_len: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden_size: Optional[int] = None   # default 4*hidden
    dtype: Any = torch.bfloat16
    remat_blocks: bool = False
    attention_impl: str = "flash"           # "flash" | "fused_softmax"
    attention_dropout: float = 0.0
    hidden_dropout: float = 0.0
    sequence_parallel: bool = False
    moe_num_experts: int = 0
    fused_lm_head: bool = True

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_torch_dtype(self.dtype))
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} not divisible "
                             f"by num_heads {self.num_heads}")
        if self.attention_impl not in ("flash", "fused_softmax"):
            raise ValueError("attention_impl must be 'flash' or "
                             f"'fused_softmax', got {self.attention_impl!r}")
        for what in ("attention_dropout", "hidden_dropout"):
            if not 0.0 <= getattr(self, what) < 1.0:
                raise ValueError(f"{what} must be in [0, 1), got "
                                 f"{getattr(self, what)}")
        unported = {
            "remat_blocks": self.remat_blocks,
            "attention_impl='fused_softmax'":
                self.attention_impl == "fused_softmax",
            "sequence_parallel": self.sequence_parallel,
            "moe_num_experts > 0": self.moe_num_experts > 0,
        }
        for what, on in unported.items():
            if on:
                raise NotImplementedError(f"GPTConfig: {what} is not ported "
                                          "to apex_tpu_torch yet")

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class _Attention(nn.Module):
    def __init__(self, cfg: GPTConfig, device):
        super().__init__()
        h = cfg.hidden_size
        self.qkv = ColumnParallelLinear(h, 3 * h, device=device)
        self.proj = RowParallelLinear(h, h, device=device)


class _MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, device):
        super().__init__()
        self.fc1 = ColumnParallelLinear(cfg.hidden_size, cfg.ffn,
                                        device=device)
        self.fc2 = RowParallelLinear(cfg.ffn, cfg.hidden_size, device=device)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device):
        super().__init__()
        h = cfg.hidden_size
        self.ln1 = FusedLayerNorm(h, dtype=cfg.dtype, device=device)
        self.attn = _Attention(cfg, device)
        self.ln2 = FusedLayerNorm(h, dtype=cfg.dtype, device=device)
        self.mlp = _MLP(cfg, device)


class GPT(nn.Module):
    """The GPT parameter tree (uninitialised: use :meth:`init_params` or
    :meth:`params_from_jax`)."""

    def __init__(self, cfg: GPTConfig, *, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        h = cfg.hidden_size
        self.wte = VocabParallelEmbedding(cfg.vocab_size, h, device=dev)
        self.wpe = nn.Parameter(torch.empty((cfg.max_seq_len, h),
                                            dtype=torch.float32, device=dev))
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", GPTBlock(cfg, dev))
        self.ln_f = FusedLayerNorm(h, dtype=cfg.dtype, device=dev)

    def block(self, i: int) -> GPTBlock:
        return getattr(self, f"block_{i}")

    @property
    def device(self) -> torch.device:
        return self.wpe.device

    # -- training forward and loss -----------------------------------------
    @staticmethod
    def _ln(mod: FusedLayerNorm, x, reference: bool):
        if reference:
            return fused_layer_norm_affine_reference(
                x, mod.weight, mod.bias, mod.normalized_shape, mod.eps,
                mod.dtype)
        return mod(x)

    def _hdrop(self, y, rngs):
        """The hidden dropout of a residual branch's output (flax's
        ``Dropout``: kept elements ``y / (1 - rate)`` in ``y``'s dtype, the
        rest 0); ``y`` itself without ``rngs`` or at rate 0."""
        rate = self.cfg.hidden_dropout
        if rngs is None or rate == 0.0:
            return y
        keep = torch.rand(y.shape, device=y.device, generator=rngs[1]) >= rate
        return torch.where(keep, y / (1.0 - rate), torch.zeros_like(y))

    def _block_forward(self, blk: GPTBlock, x, reference: bool, rngs=None):
        cfg = self.cfg
        b, s, h = x.shape
        d = cfg.head_dim
        y = self._ln(blk.ln1, x, reference)
        qkv = blk.attn.qkv(y).reshape(b, s, cfg.num_heads, 3 * d)
        q, k, v = (t.transpose(1, 2).contiguous()
                   for t in qkv.split(d, dim=-1))          # [b, heads, s, d]
        rate, seed = 0.0, None
        if rngs is not None and cfg.attention_dropout > 0:
            # the JAX model's seed plus the tensor-parallel rank (0 here)
            rate = cfg.attention_dropout
            seed = int(torch.randint(0, 2 ** 30 - 1, (), generator=rngs[0]))
        attend = mha_reference if reference else flash_attention
        ctx = attend(q, k, v, causal=True, scale=d ** -0.5,
                     dropout_rate=rate, dropout_seed=seed)
        x = x + self._hdrop(
            blk.attn.proj(ctx.transpose(1, 2).reshape(b, s, h)), rngs)
        y = self._ln(blk.ln2, x, reference)
        y = blk.mlp.fc1(y)
        y = F.gelu(y.float(), approximate="tanh").to(x.dtype)
        return x + self._hdrop(blk.mlp.fc2(y), rngs)

    def _dropout_rngs(self, deterministic: bool,
                      generator: Optional[torch.Generator]):
        """``(host generator, device generator)`` of a training forward
        with dropout, or None (deterministic, or both rates 0)."""
        cfg = self.cfg
        if deterministic or (cfg.attention_dropout == 0.0
                             and cfg.hidden_dropout == 0.0):
            return None
        if generator is None or generator.device.type != "cpu":
            raise ValueError(
                "GPT: deterministic=False with dropout needs a host (CPU) "
                "torch.Generator (its draws never wait for the device)")
        dev = torch.Generator(device=self.device)
        dev.manual_seed(int(torch.randint(0, 2 ** 62, (),
                                          generator=generator)))
        return generator, dev

    def forward(self, ids, return_hidden: bool = False,
                reference: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Logits ``[b, s, V]`` in ``cfg.dtype`` (the tied LM head), or
        with ``return_hidden`` the final LayerNorm's output ``[b, s, h]``.
        ``ids``: ``[b, s]`` int. ``deterministic=False`` trains with the
        config's dropout, drawn from ``generator`` (module docstring): the
        same generator state gives the same masks, through the kernels or
        (``reference=True``) their plain versions."""
        cfg = self.cfg
        rngs = self._dropout_rngs(deterministic, generator)
        s = ids.shape[1]
        x = self.wte(ids).to(cfg.dtype) + self.wpe[:s].to(cfg.dtype)[None]
        for i in range(cfg.num_layers):
            x = self._block_forward(self.block(i), x, reference, rngs)
        x = self._ln(self.ln_f, x, reference)
        if return_hidden:
            return x
        return self.wte.attend(x)

    def loss(self, ids, labels, reference: bool = False,
             deterministic: bool = True,
             generator: Optional[torch.Generator] = None):
        """Mean next-token cross entropy over all ``b * s`` tokens (fp32
        scalar); ``deterministic``/``generator`` as :meth:`forward`."""
        kw = dict(reference=reference, deterministic=deterministic,
                  generator=generator)
        if self.cfg.fused_lm_head:
            x = self.forward(ids, return_hidden=True, **kw)
            ce = (lm_head_cross_entropy_reference if reference
                  else fused_lm_head_cross_entropy)
            return ce(x, self.wte.embedding, labels).mean()
        logits = self.forward(ids, **kw)
        return vocab_parallel_cross_entropy(logits, labels).mean()

    @classmethod
    def init_params(cls, cfg: GPTConfig,
                    generator: Optional[torch.Generator] = None, *,
                    device: DeviceLike = None) -> "GPT":
        """Random parameters from the flax initialisers' distributions,
        drawn on the CPU from ``generator`` in parameter order and copied
        to ``device``."""
        model = cls(cfg, device=device)
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            cpu = torch.empty(p.shape, dtype=torch.float32)
            if name in ("wte.embedding", "wpe"):
                cpu.normal_(0.0, 0.02, generator=generator)
            elif leaf == "kernel":
                # flax lecun_normal: truncated at +-2 std, rescaled so the
                # truncated distribution has variance 1/fan_in
                std = math.sqrt(1.0 / p.shape[0]) / .87962566103423978
                nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif leaf == "weight":
                cpu.fill_(1.0)
            else:
                cpu.zero_()
            p.data.copy_(cpu)
        return model

    @classmethod
    def params_from_jax(cls, cfg: GPTConfig, tree: Mapping, *,
                        device: DeviceLike = None) -> "GPT":
        """The port's parameters from a JAX GPT parameter tree (nested
        mappings of numpy arrays, as ``jax.device_get(params)`` gives).
        Layouts carry over unchanged; each leaf keeps its dtype (bfloat16
        leaves arrive as ``ml_dtypes`` arrays)."""
        model = cls(cfg, device=device)
        names = dict(model.named_parameters())
        flat = {}

        def walk(node, prefix):
            for key in node:
                val = node[key]
                path = f"{prefix}{key}"
                if isinstance(val, Mapping):
                    walk(val, path + ".")
                else:
                    flat[path] = val

        walk(tree, "")
        if set(flat) != set(names):
            raise ValueError(
                "JAX tree does not match the port's GPT: missing "
                f"{sorted(set(names) - set(flat))}, unexpected "
                f"{sorted(set(flat) - set(names))}")
        for name, p in names.items():
            arr = np.asarray(flat[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            dtype = as_torch_dtype(arr.dtype)
            t = torch.from_numpy(np.array(arr, np.float32))
            p.data = t.to(device=p.device, dtype=dtype)
        return model
