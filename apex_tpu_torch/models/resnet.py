"""ResNet (``apex_tpu/models/resnet.py``): the torchvision ResNet-50 of the
imagenet example, with the JAX package's module tree and arithmetic.

Layout: the port takes NCHW inputs, PyTorch's convention; the JAX package
takes NHWC, so a test transposes the same numbers for each side. Modules
carry the flax tree's names (``Conv_0``, ``_BNWrap_0``, ``Bottleneck_3``,
``Dense_0``), so :meth:`ResNet.params_from_jax` maps a flax
``{"params", "batch_stats"}`` tree leaf for leaf: conv kernels HWIO ->
OIHW, the Dense kernel ``[in, out]`` -> ``nn.Linear``'s ``[out, in]``,
BatchNorm ``scale``/``bias`` -> ``weight``/``bias`` and ``mean``/``var`` ->
``running_mean``/``running_var``.

Arithmetic, as the JAX package computes it:

- ``dtype`` is the compute type: the input is cast to it, and each conv
  runs in it (under O2 the cast gives bf16 weights; fp32 weights are cast
  per call otherwise, as flax promotes them);
- :class:`_BNWrap` normalizes in fp32 with fp32 parameters and returns the
  input's dtype (``bn(x.astype(f32)).astype(x.dtype)``). The running
  statistics follow flax: ``ra = momentum * ra + (1 - momentum) * batch``
  with ``momentum`` 0.9 and the **biased** batch variance. Torch's
  ``F.batch_norm(training=True)`` writes the unbiased one, so the module
  scales the variance term torch added by ``(n - 1) / n`` (``n`` values
  per channel), which costs a few [C]-sized operations where computing
  the statistics again would read the activation once more;
- max pooling pads with -inf in both frameworks;
- the head averages over H and W in fp32 and rounds the mean to the
  compute dtype (``jnp.mean`` of bf16), then applies the Dense layer in
  fp32 to its weight as stored: bf16-rounded under O2, so the logits are
  fp32 products of bf16-rounded values.

Convolutions and batch norm are no Pallas kernels in the JAX package (XLA
lowers flax's ``nn.Conv``/``nn.BatchNorm``); here they are ``F.conv2d``
and ``F.batch_norm`` (cuDNN on the card). ``channels_last`` is the fast
layout for bf16 convs on the card: ``model.to(memory_format=
torch.channels_last)`` and a channels-last input.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._compat import DeviceLike, as_torch_dtype, resolve_device


class _BNWrap(nn.Module):
    """Batch norm in fp32 (parameters and statistics), flax's running
    statistics, output in the input's dtype."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, *, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(num_features, **f32))
        self.bias = nn.Parameter(torch.zeros(num_features, **f32))
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))

    def forward(self, x, use_running_average: bool = False):
        w, b = self.weight.float(), self.bias.float()
        if use_running_average:
            return F.batch_norm(x, self.running_mean, self.running_var, w, b,
                                False, 0.0, self.eps)
        # batch statistics in fp32 from the input as it is, fp32 affine,
        # one rounding to the input's dtype; torch's momentum is flax's
        # 1 - momentum
        # (autograd saves the running buffers it is handed: torch updates
        # copies, which nothing modifies afterwards)
        m = self.momentum
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, w, b, True, 1.0 - m, self.eps)
        with torch.no_grad():
            # torch wrote m * ra + (1 - m) * var * n / (n - 1), the
            # unbiased variance; flax keeps the biased one
            n = x.numel() // x.shape[1]
            added = var - m * self.running_var
            self.running_var.copy_(m * self.running_var
                                   + added * ((n - 1) / n))
            self.running_mean.copy_(mean)
        return y


def _conv(x, weight, dtype, stride=1, padding=0):
    return F.conv2d(x, weight.to(dtype), None, stride, padding)


class Bottleneck(nn.Module):
    """1x1-3x3-1x1 bottleneck block, the stride on the 3x3 (ResNet v1.5)."""

    expansion = 4

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 norm: Callable = _BNWrap, dtype: Any = torch.float32, *,
                 device=None):
        super().__init__()
        out = filters * self.expansion
        self.dtype = as_torch_dtype(dtype)
        self.strides = strides
        self.needs_proj = in_features != out or strides != 1
        kw = dict(dtype=torch.float32, device=device)
        self.Conv_0 = nn.Parameter(torch.empty(filters, in_features, 1, 1,
                                               **kw))
        self._BNWrap_0 = norm(num_features=filters, device=device)
        self.Conv_1 = nn.Parameter(torch.empty(filters, filters, 3, 3, **kw))
        self._BNWrap_1 = norm(num_features=filters, device=device)
        self.Conv_2 = nn.Parameter(torch.empty(out, filters, 1, 1, **kw))
        self._BNWrap_2 = norm(num_features=out, device=device)
        if self.needs_proj:
            self.Conv_3 = nn.Parameter(torch.empty(out, in_features, 1, 1,
                                                   **kw))
            self._BNWrap_3 = norm(num_features=out, device=device)

    def forward(self, x, train: bool = True):
        eval_ = not train
        y = _conv(x, self.Conv_0, self.dtype)
        y = F.relu(self._BNWrap_0(y, eval_))
        y = _conv(y, self.Conv_1, self.dtype, self.strides, 1)
        y = F.relu(self._BNWrap_1(y, eval_))
        y = _conv(y, self.Conv_2, self.dtype)
        y = self._BNWrap_2(y, eval_)
        residual = x
        if self.needs_proj:
            residual = _conv(x, self.Conv_3, self.dtype, self.strides)
            residual = self._BNWrap_3(residual, eval_)
        return F.relu(y + residual)


class BasicBlock(nn.Module):
    """3x3-3x3 block of ResNet-18/34."""

    expansion = 1

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 norm: Callable = _BNWrap, dtype: Any = torch.float32, *,
                 device=None):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        self.strides = strides
        self.needs_proj = in_features != filters or strides != 1
        kw = dict(dtype=torch.float32, device=device)
        self.Conv_0 = nn.Parameter(torch.empty(filters, in_features, 3, 3,
                                               **kw))
        self._BNWrap_0 = norm(num_features=filters, device=device)
        self.Conv_1 = nn.Parameter(torch.empty(filters, filters, 3, 3, **kw))
        self._BNWrap_1 = norm(num_features=filters, device=device)
        if self.needs_proj:
            self.Conv_2 = nn.Parameter(torch.empty(filters, in_features, 1, 1,
                                                   **kw))
            self._BNWrap_2 = norm(num_features=filters, device=device)

    def forward(self, x, train: bool = True):
        eval_ = not train
        y = _conv(x, self.Conv_0, self.dtype, self.strides, 1)
        y = F.relu(self._BNWrap_0(y, eval_))
        y = _conv(y, self.Conv_1, self.dtype, 1, 1)
        y = self._BNWrap_1(y, eval_)
        residual = x
        if self.needs_proj:
            residual = _conv(x, self.Conv_2, self.dtype, self.strides)
            residual = self._BNWrap_2(residual, eval_)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """``ResNet(stage_sizes, block_cls, num_classes, num_filters, norm,
    dtype)`` as in the JAX package; ``forward(x, train=True)`` takes
    ``x`` [N, 3, H, W] and returns fp32 logits [N, num_classes]. In
    training mode the batch norms update their running statistics in
    place."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: type = None,
                 num_classes: int = 1000, num_filters: int = 64,
                 norm: Callable = _BNWrap, dtype: Any = torch.float32, *,
                 in_channels: int = 3, device: DeviceLike = None):
        super().__init__()
        block_cls = Bottleneck if block_cls is None else block_cls
        dev = resolve_device(device)
        self.dtype = as_torch_dtype(dtype)
        self.stage_sizes = tuple(stage_sizes)
        self.Conv_0 = nn.Parameter(torch.empty(
            num_filters, in_channels, 7, 7, dtype=torch.float32, device=dev))
        self._BNWrap_0 = norm(num_features=num_filters, device=dev)
        feats, idx = num_filters, 0
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                blk = block_cls(feats, num_filters * 2 ** i, strides, norm,
                                self.dtype, device=dev)
                self.add_module(f"{block_cls.__name__}_{idx}", blk)
                feats = num_filters * 2 ** i * block_cls.expansion
                idx += 1
        self.n_blocks = idx
        self.block_name = block_cls.__name__
        self.Dense_0 = nn.Linear(feats, num_classes, dtype=torch.float32,
                                 device=dev)

    def blocks(self):
        return [getattr(self, f"{self.block_name}_{i}")
                for i in range(self.n_blocks)]

    def forward(self, x, train: bool = True):
        eval_ = not train
        x = x.to(self.dtype)
        x = _conv(x, self.Conv_0, self.dtype, 2, 3)
        x = F.relu(self._BNWrap_0(x, eval_))
        x = F.max_pool2d(x, 3, 2, 1)
        for blk in self.blocks():
            x = blk(x, train)
        # jnp.mean of the compute dtype: an fp32 mean rounded to it
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(self.dtype)
        return F.linear(x.float(), self.Dense_0.weight.float(),
                        self.Dense_0.bias.float())

    @classmethod
    def init_params(cls, *args, generator: Optional[torch.Generator] = None,
                    device: DeviceLike = None, **kwargs) -> "ResNet":
        """A ResNet with random weights from flax's initialisers'
        distributions, drawn on the CPU from ``generator`` in parameter
        order: conv and Dense kernels ``lecun_normal`` (truncated normal at
        two standard deviations, variance 1/fan_in), the Dense bias zeros;
        the batch norms keep their construction values (weight 1, bias 0,
        running mean 0, running variance 1). The numbers differ from a flax
        init with the same seed; tests carry flax params across instead."""
        model = cls(*args, device=device, **kwargs)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if p.dim() >= 2:
                    fan_in = int(np.prod(p.shape[1:]))
                    std = (1.0 / fan_in) ** 0.5 / .87962566103423978
                    cpu = torch.empty(p.shape, dtype=torch.float32)
                    nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                    p.copy_(cpu)
                elif name == "Dense_0.bias":
                    p.zero_()
        return model

    @classmethod
    def params_from_jax(cls, *args, variables: Mapping,
                        device: DeviceLike = None, **kwargs) -> "ResNet":
        """A ResNet built with the JAX constructor arguments, its
        parameters and running statistics copied from a flax
        ``{"params": ..., "batch_stats": ...}`` tree of numpy arrays
        (``jax.device_get(variables)``); each leaf keeps its dtype."""
        model = cls(*args, device=device, **kwargs)
        flat = {}

        def walk(node, path):
            for key in node:
                val = node[key]
                if isinstance(val, Mapping):
                    walk(val, path + (key,))
                else:
                    flat[path + (key,)] = val

        walk(variables["params"], ("params",))
        if "batch_stats" in variables:
            walk(variables["batch_stats"], ("batch_stats",))
        targets = dict(model.named_parameters())
        targets.update(model.named_buffers())
        seen = set()
        for path, val in flat.items():
            coll, *scope, leaf = path
            if scope and scope[-1] == "BatchNorm_0":     # _BNWrap's child
                scope = scope[:-1]
                leaf = {"scale": "weight", "bias": "bias", "mean":
                        "running_mean", "var": "running_var"}[leaf]
                name = ".".join(scope + [leaf])
            elif scope[-1] == "Dense_0":
                name = ".".join(scope + [{"kernel": "weight",
                                          "bias": "bias"}[leaf]])
            else:                                        # a conv kernel
                name = ".".join(scope)
            if name not in targets:
                raise ValueError(f"flax leaf {'/'.join(path)} has no "
                                 f"counterpart {name!r} in the port")
            arr = np.asarray(val)
            dtype = as_torch_dtype(arr.dtype)
            t = torch.from_numpy(np.array(arr, np.float32))
            if t.dim() == 4:                         # HWIO -> OIHW
                t = t.permute(3, 2, 0, 1)
            elif t.dim() == 2:                       # [in, out] -> [out, in]
                t = t.t()
            dst = targets[name]
            if tuple(t.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: flax shape {tuple(t.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.data = t.contiguous().to(device=dst.device, dtype=dtype)
            seen.add(name)
        missing = sorted(set(targets) - seen)
        if missing:
            raise ValueError(f"the flax tree lacks {missing}")
        return model


class ResNet18(ResNet):
    """ResNet-18: BasicBlock stages (2, 2, 2, 2)."""

    def __init__(self, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock,
                 **kwargs):
        super().__init__(stage_sizes, block_cls, **kwargs)


class ResNet50(ResNet):
    """ResNet-50: Bottleneck stages (3, 4, 6, 3)."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck,
                 **kwargs):
        super().__init__(stage_sizes, block_cls, **kwargs)


class ResNet101(ResNet):
    """ResNet-101: Bottleneck stages (3, 4, 23, 3)."""

    def __init__(self, stage_sizes=(3, 4, 23, 3), block_cls=Bottleneck,
                 **kwargs):
        super().__init__(stage_sizes, block_cls, **kwargs)
