"""amp frontend: ``initialize``, the opt-level cast and the train step
(``apex_tpu/amp/frontend.py``).

- ``initialize(model, optimizer, opt_level=...)`` returns an
  :class:`AmpModel` around the ``nn.Module`` and the optimizer with the
  opt level's master-weight mode and loss scaler attached.
- ``amp_model.cast_params()`` casts the module's parameters in place per
  the opt level. Under O2 (``keep_batchnorm_fp32``) the parameters of
  every module that owns running statistics stay fp32, whatever its name
  — the structural ``isinstance(_BatchNorm)`` rule, which the JAX package
  reads from the ``batch_stats`` collection (``_batch_stats_scopes``) and
  the port from ``running_mean``/``running_var`` buffers — with the name
  heuristic ``_is_norm_param`` as the fallback. LayerNorm weights and
  biases, which own no running statistics, go to the half type, in both
  packages. Buffers are never cast.
- ``make_train_step(loss_fn, optimizer)`` builds the hot loop: scaled
  loss → backward → unscale with overflow detection → optimizer step
  skipped on the device when a gradient overflowed → scaler update. The
  step reads nothing back to the host; the loss comes back as a device
  tensor.

- ``initialize(..., zero=...)`` (``True``, a dict of keywords or a
  ``ZeroShardedModel``) wraps the one model in a
  :class:`~apex_tpu_torch.zero.ZeroShardedModel` that carries the amp
  model's cast, and points each optimizer at it; ``zero.make_train_step``
  is the sharded hot loop. ``zero=`` survives ``enabled=False``.

Not ported yet (each raises ``NotImplementedError``): O1 (the autocast
policy and cast lists), O4 / fp8 training.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
from torch import nn

from apex_tpu_torch.amp import scaler as _scaler_mod
from apex_tpu_torch.amp._amp_state import _amp_state, maybe_print, \
    warn_or_err
from apex_tpu_torch.amp.properties import Properties, opt_levels
from apex_tpu_torch.amp.scaler import LossScaler, ScalerState
from apex_tpu_torch.utils.tree import cast_floating, path_names


def _is_norm_param(path_names: tuple) -> bool:
    """Name-based analog of ``isinstance(module, _BatchNorm)``
    (``apex/fp16_utils/fp16util.py:27-39``): flax/haiku BN scopes are named
    ``BatchNorm*`` / ``bn*`` / ``batch_stats``."""
    joined = "/".join(path_names).lower()
    return any(k in joined for k in ("batchnorm", "batch_norm", "batch_stats", "/bn", "bn_", "sync_bn", "syncbn"))


_RUNNING_STATS = ("running_mean", "running_var")


def _batch_stats_scopes(module: nn.Module) -> frozenset:
    """Path names of the modules that own running statistics (a
    ``running_mean`` or ``running_var`` buffer) — the structural signal of
    a batch norm, whatever the module is called. The JAX package reads the
    same from the scopes of the ``batch_stats`` collection."""
    scopes = set()
    for name, _ in module.named_buffers():
        names = path_names(name)
        if names[-1] in _RUNNING_STATS:
            scopes.add(names[:-1])
    return frozenset(scopes)


def _cast_tensors(obj, dtype):
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cast_tensors(o, dtype) for o in obj)
    if isinstance(obj, dict):
        return {k: _cast_tensors(v, dtype) for k, v in obj.items()}
    return obj


class AmpModel:
    """The module with the opt level's casts: ``amp_model(*args)`` casts
    floating inputs to the model type, runs the module and casts floating
    outputs to fp32 (O2/O3) or ``cast_model_outputs``."""

    def __init__(self, module: nn.Module, properties: Properties,
                 keep_fp32_predicate: Optional[Callable] = None):
        self.module = module
        self.properties = properties
        self._keep_fp32_is_default = keep_fp32_predicate is None
        self._keep_fp32 = keep_fp32_predicate or (
            (lambda names, x: not _is_norm_param(names))
            if properties.keep_batchnorm_fp32 else None)

    def cast_params(self, module: Optional[nn.Module] = None) -> nn.Module:
        """Cast the module's parameters in place per the opt level and
        return the module. O2/O3: floating parameters -> half; under O2
        the parameters of modules owning running statistics stay fp32
        (structurally, else by name: module docstring); an explicit
        ``keep_fp32_predicate`` overrides both. O0: -> fp32."""
        module = self.module if module is None else module
        ct = self.properties.cast_model_type
        if ct is None:
            return module
        return cast_floating(module, ct, self._keep_fn(module))

    def _keep_fn(self, module: nn.Module):
        """The cast predicate: the explicit one, else the structural
        running-statistics rule with the name rule as fallback."""
        keep = self._keep_fp32
        if self._keep_fp32_is_default and self.properties.keep_batchnorm_fp32:
            scopes = _batch_stats_scopes(module)
            if scopes:
                def keep(names, x, _scopes=scopes):
                    return not (names[:-1] in _scopes
                                or _is_norm_param(names))
        return keep

    def cast_tree(self, tree) -> dict:
        """The same cast over a ``name -> tensor`` tree (the ZeRO resident
        shards), out of place: cast leaves are new tensors, the others
        pass through."""
        ct = self.properties.cast_model_type
        if ct is None:
            return dict(tree)
        keep = self._keep_fn(self.module)
        out = {}
        for name, x in tree.items():
            if (x.is_floating_point() and x.dtype != ct
                    and (keep is None or keep(path_names(name), x))):
                x = x.to(ct)
            out[name] = x
        return out

    def _cast_in(self, args, kwargs):
        p = self.properties
        half = (p.cast_model_type is not None
                and p.cast_model_type != torch.float32)
        if half:
            args = _cast_tensors(args, p.cast_model_type)
            kwargs = _cast_tensors(kwargs, p.cast_model_type)
        return half, args, kwargs

    def _cast_out(self, out, half):
        p = self.properties
        if p.cast_model_outputs is not None:
            return _cast_tensors(out, p.cast_model_outputs)
        return _cast_tensors(out, torch.float32) if half else out

    def call_with(self, params, *args, **kwargs):
        """The amp call with the module's parameters replaced by
        ``params`` (``name -> tensor``) — the ZeRO forward."""
        half, args, kwargs = self._cast_in(args, kwargs)
        out = torch.func.functional_call(self.module, dict(params), args,
                                         kwargs)
        return self._cast_out(out, half)

    def __call__(self, *args, **kwargs):
        half, args, kwargs = self._cast_in(args, kwargs)
        return self._cast_out(self.module(*args, **kwargs), half)


def _model_device(models: List) -> torch.device:
    for m in models:
        for p in m.parameters():
            return p.device
    raise ValueError("amp.initialize: the model has no parameters")


def initialize(models, optimizers=None, enabled: bool = True,
               opt_level: str = "O1", *, half_dtype=None,
               cast_model_type=None, cast_ops=None,
               keep_batchnorm_fp32=None, master_weights=None,
               loss_scale=None, cast_model_outputs=None,
               num_losses: int = 1, verbosity: int = 1,
               min_loss_scale: Optional[float] = None,
               max_loss_scale: float = 2.0 ** 24,
               keep_fp32_predicate: Optional[Callable] = None, zero=None):
    """``models``: an ``nn.Module`` or a list of them; ``optimizers``: the
    port's fused optimizer(s), or None. Returns ``(models, optimizers)``
    with the list-ness of the inputs. The loss scalers live on the device
    of the first model's parameters."""
    _amp_state.verbosity = verbosity
    use_zero = zero is not None and zero is not False
    opts_was_list = isinstance(optimizers, (list, tuple))
    opt_list = (list(optimizers) if opts_was_list
                else [optimizers] if optimizers is not None else [])
    models_was_list = isinstance(models, (list, tuple))
    model_list = list(models) if models_was_list else [models]
    if not enabled:
        _amp_state.enabled = False
        _amp_state.opt_properties = None
        _amp_state.loss_scalers = []
        if use_zero:
            # amp is inert, but the zero= surface survives: code written
            # against ZeroShardedModel runs unchanged at full precision
            zm = _wrap_zero(zero, model_list, opt_list)
            models = [zm] if models_was_list else zm
        return models if optimizers is None else (models, optimizers)
    _amp_state.enabled = True
    if opt_level not in opt_levels:
        raise RuntimeError(f"Unexpected optimization level {opt_level}. "
                           "Options are 'O0', 'O1', 'O2', 'O3', 'O4'.")
    if cast_ops:
        raise NotImplementedError("cast_ops (the O1 autocast policy) is not "
                                  "ported yet")
    properties = Properties()
    if half_dtype is not None:
        properties.half_dtype = half_dtype
    properties = opt_levels[opt_level](properties)
    maybe_print(f"Selected optimization level {opt_level}: "
                f"{opt_levels[opt_level].brief}", True)
    overrides = dict(cast_model_type=cast_model_type,
                     keep_batchnorm_fp32=keep_batchnorm_fp32,
                     master_weights=master_weights, loss_scale=loss_scale,
                     cast_model_outputs=cast_model_outputs)
    for k, v in overrides.items():
        if v is not None:
            maybe_print(f"Overriding {k}: {v}", True)
            setattr(properties, k, v)
    if properties.keep_batchnorm_fp32 and properties.cast_model_type is None:
        warn_or_err("keep_batchnorm_fp32 only makes sense with a "
                    "cast_model_type (O2/O3).")
    if properties.master_weights and properties.cast_model_type is None:
        warn_or_err("master_weights requires cast_model_type (O2).")
    _amp_state.opt_properties = properties

    amp_models = [AmpModel(m, properties, keep_fp32_predicate)
                  for m in model_list]
    device = _model_device(model_list)
    scalers = [LossScaler(properties.loss_scale,
                          min_loss_scale=min_loss_scale,
                          max_loss_scale=max_loss_scale, device=device)
               for _ in range(num_losses)]
    _amp_state.loss_scalers = scalers

    for opt in opt_list:
        opt.configure_amp(properties, scalers[0])
    if use_zero:
        amp_models = [_wrap_zero(zero, model_list, opt_list,
                                 amp_model=amp_models[0])]
    out_models = amp_models if models_was_list else amp_models[0]
    if optimizers is None:
        return out_models
    return out_models, (opt_list if opts_was_list else opt_list[0])


def _wrap_zero(zero, model_list, opt_list, amp_model=None):
    """Wrap the (single) model in a :class:`~apex_tpu_torch.zero.
    ZeroShardedModel` and point each optimizer at it —
    ``zero.make_train_step`` takes its model from ``opt._zero_model``.
    ``zero``: True, a dict of ``ZeroShardedModel`` keywords, or a
    ``ZeroShardedModel`` (whose module is set to the model)."""
    from apex_tpu_torch.zero import ZeroShardedModel
    from apex_tpu_torch.zero.comm import same_group
    if len(model_list) != 1:
        raise ValueError(
            "initialize(zero=...) supports exactly one model (the sharded "
            f"parameter tree belongs to one forward); got {len(model_list)}")
    if isinstance(zero, ZeroShardedModel):
        zm = zero
        zm.module = model_list[0]
    else:
        zm = ZeroShardedModel(model_list[0],
                              **({} if zero is True else dict(zero)))
    zm._amp_model = amp_model
    for opt in opt_list:
        if hasattr(opt, "group") and not same_group(opt.group, zm.group):
            raise ValueError(
                "initialize(zero=...): optimizer.group is not the zero "
                "group — the shard update would run its collectives over "
                "another group than the gradients; construct the optimizer "
                "with the zero group")
        opt._zero_model = zm
    return zm


def state_dict(destination: Optional[dict] = None) -> dict:
    d = {} if destination is None else destination
    for i, s in enumerate(_amp_state.loss_scalers):
        d[f"loss_scaler{i}"] = s.state_dict()
    return d


def load_state_dict(sd: dict):
    for key, v in sd.items():
        idx = int(key.replace("loss_scaler", ""))
        if idx < len(_amp_state.loss_scalers):
            _amp_state.loss_scalers[idx].load_state_dict(v)


def make_train_step(loss_fn: Callable, optimizer, *,
                    scaler: Optional[LossScaler] = None, fp8: bool = False):
    """A training step with amp semantics.

    ``loss_fn(params, *batch) -> loss``, where ``params`` is what the
    caller hands the step — typically the module. The returned
    ``step(params, opt_state, scaler_state, *batch)`` runs scale →
    backward → unscale (one flat fp32 gradient buffer, overflow flag) →
    optimizer step on that buffer, skipped on the device on overflow →
    scaler update, and returns ``(params, opt_state, scaler_state,
    loss)``. The optimizer's parameters are updated in place; ``loss`` is
    a device tensor; nothing is read back to the host."""
    if fp8:
        raise NotImplementedError("make_train_step(fp8=True) (O4) is not "
                                  "ported yet")
    scaler = scaler or optimizer._scaler
    if scaler is None:
        raise ValueError("make_train_step: no scaler; pass scaler= or run "
                         "amp.initialize with the optimizer first")

    def step(params, opt_state, scaler_state: ScalerState, *batch):
        flat = [p for g in optimizer.param_groups for p in g["params"]]
        for p in flat:
            p.grad = None
        loss = loss_fn(params, *batch)
        _scaler_mod.scale_value(loss, scaler_state).backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in flat]
        for p in flat:
            p.grad = None
        g32, found_inf = _scaler_mod.unscale(grads, scaler_state)
        new_opt_state = optimizer.apply_flat(opt_state, g32, skip=found_inf)
        new_scaler_state = scaler.update_state(scaler_state, found_inf)
        return params, new_opt_state, new_scaler_state, loss.detach()

    return step
