"""apex_tpu_torch's ResNet and its O2 training step against the JAX package,
on a tiny ResNet: ``stage_sizes=(1, 1)``, 8 filters, 10 classes, 32x32
inputs, batch 4, with Bottleneck and with BasicBlock blocks.

The model is initialised by flax and carried across with
``ResNet.params_from_jax``; inputs and labels are made with numpy from a
seed. JAX takes NHWC inputs and the port NCHW, so the port's input is the
same numbers transposed. The JAX side is the bench's step
(``bench.py:149-188``): O2 (bf16 model, fp32 BatchNorm, fp32 masters,
dynamic loss scale), ``FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)``,
``mean(softmax_cross_entropy_with_smoothing(logits, y, 0.1))``, batch
statistics threaded through ``mutable=["batch_stats"]``; the port's is
``amp.make_train_step`` over the same recipe, its batch norms updating
their running statistics in place.

Tolerances and their reasons:

- fp32 forward: logits in train and eval mode and the running statistics
  after one train forward, within 1e-4 of the largest value (fp32 convs
  and batch statistics summed in other orders by XLA and oneDNN; flax
  takes the variance as E[x^2] - E[x]^2, torch by two passes);
- fp32 gradients of one step's loss (the loss of ``bench.py``'s step,
  through the port's plain twin of the cross entropy) against
  ``jax.grad``: within 1e-5 of each parameter's largest gradient (read:
  7.4e-6 at worst);
- the O2 step, three steps. bf16 convs accumulate in other orders in XLA
  and oneDNN and each side rounds to bf16 at the same points, and on a
  batch of 4 the batch-norm backward cancels: one step's conv and norm
  gradients differ from the fp32 ones by up to 50 % in relative norm on
  either side, and the port's from JAX's by up to 13 % (Bottleneck). Read
  after three steps (Bottleneck / BasicBlock): losses 5.4e-3 / 4.5e-3
  apart, masters 3.0e-2 / 8.8e-3 apart (largest 0.8), momentum buffers
  0.27 / 0.094 apart in relative norm over all parameters, batch
  statistics 1.2e-2 / 7.6e-3 of the largest (1.3 / 1.5).
  Held at: losses 2e-2, masters 6e-2, momentum 0.5 in relative norm,
  batch statistics 3e-2 of the largest; ``initialized`` and the scaler
  state exactly. The fp32 gradient test above is the check of the
  semantics; this one shows the bf16 path runs the same recipe.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu.amp import scaler as jscaler
from apex_tpu.models.resnet import BasicBlock as JBasicBlock
from apex_tpu.models.resnet import Bottleneck as JBottleneck
from apex_tpu.models.resnet import ResNet as JResNet
from apex_tpu.ops import softmax_cross_entropy_with_smoothing as jxent
from apex_tpu.optimizers import FusedSGD as JFusedSGD
from apex_tpu_torch import amp
from apex_tpu_torch.amp.frontend import _is_norm_param
from apex_tpu_torch.models.resnet import BasicBlock, Bottleneck, ResNet
from apex_tpu_torch.ops import fused_ce as tfc
from apex_tpu_torch.optimizers import FusedSGD

B, HW, CLASSES, FILTERS = 4, 32, 10, 8
ARCH = dict(stage_sizes=(1, 1), num_classes=CLASSES, num_filters=FILTERS)
BLOCKS = {"bottleneck": (JBottleneck, Bottleneck),
          "basic": (JBasicBlock, BasicBlock)}
SGD = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, HW, HW, 3).astype(np.float32)          # NHWC
    y = rng.randint(0, CLASSES, B).astype(np.int32)
    return x, y


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module", params=sorted(BLOCKS))
def setup(request):
    jblock, tblock = BLOCKS[request.param]
    x, _ = _batch()
    jmodel = JResNet(block_cls=jblock, **ARCH)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x), train=True))
    return jblock, tblock, variables


def _port(tblock, variables, dtype=torch.float32):
    return ResNet.params_from_jax(block_cls=tblock, dtype=dtype,
                                  variables=variables, device="cpu", **ARCH)


def _close(got, ref, rel, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def _same_tree_as_port(tblock, variables):
    """The port's named tensors holding a flax tree (carried across with
    ``params_from_jax``), for comparing a JAX result with the port's."""
    m = _port(tblock, variables)
    return {**{n: p.detach() for n, p in m.named_parameters()},
            **dict(m.named_buffers())}


def test_fp32_forward_and_running_stats_match_flax(setup):
    jblock, tblock, variables = setup
    x, _ = _batch()
    jmodel = JResNet(block_cls=jblock, **ARCH)
    model = _port(tblock, variables)
    assert model.Conv_0.shape == (FILTERS, 3, 7, 7)           # OIHW
    assert model.Dense_0.weight.shape == (CLASSES, 4 * FILTERS
                                          * (4 if tblock is Bottleneck
                                             else 1) // 2)
    with torch.no_grad():
        got_eval = model(_nchw(x), train=False)
        got = model(_nchw(x), train=True)
    want_eval = jmodel.apply(variables, jnp.asarray(x), train=False)
    want, upd = jmodel.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    assert got.dtype == torch.float32 and got.shape == (B, CLASSES)
    _close(got_eval, want_eval, 1e-4, "eval logits")
    _close(got, want, 1e-4, "train logits")
    stats = _same_tree_as_port(tblock, {"params": variables["params"],
                                        "batch_stats": jax.device_get(
                                            upd["batch_stats"])})
    for name, buf in model.named_buffers():
        _close(buf, stats[name], 1e-4, name)


def test_fp32_gradients_match_jax_grad(setup):
    jblock, tblock, variables = setup
    x, y = _batch(1)
    jmodel = JResNet(block_cls=jblock, **ARCH)

    def jloss(p):
        logits, _ = jmodel.apply({"params": p,
                                  "batch_stats": variables["batch_stats"]},
                                 jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        return jnp.mean(jxent(logits, jnp.asarray(y), 0.1))

    jl, jg = jax.value_and_grad(jloss)(variables["params"])
    want = _same_tree_as_port(tblock, {"params": jax.device_get(jg),
                                       "batch_stats": variables[
                                           "batch_stats"]})
    model = _port(tblock, variables)
    loss = tfc.softmax_cross_entropy_with_smoothing(
        model(_nchw(x)), torch.from_numpy(y).long(), 0.1).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    for name, p in model.named_parameters():
        _close(p.grad, want[name], 1e-5, name)


def test_params_from_jax_rejects_a_foreign_tree(setup):
    _, tblock, variables = setup
    bad = {"params": {**variables["params"], "Extra_0": {
        "kernel": np.zeros((3, 3))}}, "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="Extra_0"):
        _port(tblock, bad)


def _jax_o2_run(jblock, variables, x, y, steps, loss_mul=1.0):
    model = JResNet(block_cls=jblock, dtype=jnp.bfloat16, **ARCH)
    amp_model, opt = jamp.initialize(
        lambda v, xx: model.apply(v, xx, train=True, mutable=["batch_stats"]),
        JFusedSGD(**SGD), opt_level="O2", verbosity=0)
    v = amp_model.cast_params(jax.tree.map(jnp.asarray, variables))
    params, stats = v["params"], v["batch_stats"]
    opt_state = opt.init(params)
    scaler = opt._amp_stash.loss_scalers[0]

    def loss_fn(p, s, xx, yy):
        logits, upd = amp_model({"params": p, "batch_stats": s}, xx)
        loss = jnp.mean(jxent(logits, yy, 0.1)) * loss_mul
        return loss, upd["batch_stats"]

    @jax.jit
    def step(p, s, o, ss, xx, yy):
        grads, (loss, new_s) = jax.grad(
            lambda pp: (lambda lo, st: (jscaler.scale_value(lo, ss),
                                        (lo, st)))(*loss_fn(pp, s, xx, yy)),
            has_aux=True)(p)
        grads, found_inf = jscaler.unscale(grads, ss)
        new_p, new_o = opt.apply(o, p, grads, skip=found_inf)
        return new_p, new_s, new_o, scaler.update_state(ss, found_inf), loss

    sstate, losses = scaler.state, []
    for _ in range(steps):
        params, stats, opt_state, sstate, loss = step(
            params, stats, opt_state, sstate, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return losses, jax.device_get((opt_state, stats)), sstate


def _port_o2(tblock, variables, **amp_kw):
    model = _port(tblock, variables, dtype=torch.bfloat16)
    amp_model, opt = amp.initialize(model, FusedSGD(**SGD), opt_level="O2",
                                    verbosity=0, **amp_kw)
    amp_model.cast_params()
    state = opt.init(model.parameters())
    step = amp.make_train_step(
        lambda m, xx, yy: tfc.softmax_cross_entropy_with_smoothing(
            amp_model(xx), yy, 0.1).mean(), opt)
    return model, opt, state, step


def test_o2_sgd_steps_match_jax(setup):
    jblock, tblock, variables = setup
    x, y = _batch(1)
    steps = 3
    jl, (jopt, jstats), jss = _jax_o2_run(jblock, variables, x, y, steps)
    model, opt, state, step = _port_o2(tblock, variables)
    sstate, tl = opt._scaler.state, []
    for _ in range(steps):
        _, state, sstate, loss = step(model, state, sstate, _nchw(x),
                                      torch.from_numpy(y).long())
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=0)
    names = [n for n, _ in model.named_parameters()]
    stat_names = [n for n, _ in model.named_buffers()]
    g = jopt.groups[0]
    want_master = _same_tree_as_port(
        tblock, {"params": g.master, "batch_stats": jstats})
    want_buf = _same_tree_as_port(
        tblock, {"params": g.slots["momentum_buffer"],
                 "batch_stats": jstats})
    master = dict(zip(names, opt.master_params(state)))
    for name, p in model.named_parameters():
        assert master[name].dtype == torch.float32
        # the module's params are the masters cast to their dtype
        assert torch.equal(p.detach(), master[name].to(p.dtype))

    def cat(tensors, keys):
        return torch.cat([tensors[k].reshape(-1).float() for k in keys])

    err = (cat(master, names) - cat(want_master, names)).abs().max()
    assert float(err) <= 6e-2, float(err)
    buf, want = state.groups[0].slots["momentum_buffer"], cat(want_buf,
                                                              names)
    rel = float((buf - want).norm() / want.norm())
    assert rel <= 0.5, rel
    stats = dict(model.named_buffers())
    assert all(b.dtype == torch.float32 for b in stats.values())
    _close(cat(stats, stat_names), cat(want_master, stat_names), 3e-2,
           "batch statistics")
    assert bool(state.groups[0].slots["initialized"]) is \
        bool(g.slots["initialized"]) is True
    # the O2 default for bf16 in both packages: a static scale of 1
    assert float(sstate.loss_scale) == float(jss.loss_scale) == 1.0
    assert int(sstate.unskipped) == int(jss.unskipped) == 0
    assert bool(sstate.overflow) is bool(jss.overflow) is False


def test_o2_overflow_step_skips_bitwise(setup):
    _, tblock, variables = setup
    x, y = _batch(2)
    model, opt, state, step = _port_o2(tblock, variables,
                                       loss_scale="dynamic")
    xb, yb = _nchw(x), torch.from_numpy(y).long()
    _, state, sstate, _ = step(model, state, opt._scaler.state, xb, yb)
    before = (state.groups[0].master.clone(),
              {k: v.clone() for k, v in state.groups[0].slots.items()},
              [p.detach().clone() for p in model.parameters()])
    amp_model = amp.AmpModel(model, opt_properties())
    big = amp.make_train_step(
        lambda m, xx, yy: tfc.softmax_cross_entropy_with_smoothing(
            amp_model(xx), yy, 0.1).mean() * 1e38, opt)
    _, state2, sstate2, _ = big(model, state, sstate, xb, yb)
    g2 = state2.groups[0]
    assert torch.equal(g2.master, before[0])
    for k, v in before[1].items():
        assert torch.equal(g2.slots[k], v), k
    assert bool(g2.slots["initialized"])
    for p, b in zip(model.parameters(), before[2]):
        assert torch.equal(p, b)
    assert float(sstate2.loss_scale) == float(sstate.loss_scale) / 2
    assert bool(sstate2.overflow) and int(sstate2.unskipped) == 0


def opt_properties():
    from apex_tpu_torch.amp._amp_state import _amp_state
    return _amp_state.opt_properties


class _NoBnNames(nn.Module):
    """Names without "bn": a conv, a torch batch norm called ``stats``, a
    LayerNorm (no running statistics) and a linear head."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3)
        self.stats = nn.BatchNorm2d(4)
        self.ln = nn.LayerNorm(4)
        self.head = nn.Linear(4, 2)


def test_o2_cast_keeps_batch_norms_fp32_by_structure(setup):
    _, tblock, variables = setup
    model = _port(tblock, variables, dtype=torch.bfloat16)
    amp_model = amp.initialize(model, opt_level="O2", verbosity=0)
    amp_model.cast_params()
    for name, p in model.named_parameters():
        norm = "_BNWrap" in name
        # the name heuristic does not see these: the structure does
        assert not _is_norm_param(tuple(name.split(".")))
        assert p.dtype == (torch.float32 if norm else torch.bfloat16), name
    for name, b in model.named_buffers():
        assert b.dtype == torch.float32, name

    net = _NoBnNames()
    assert not any("bn" in n.lower() for n, _ in net.named_parameters())
    amp.initialize(net, opt_level="O2", verbosity=0).cast_params()
    assert net.stats.weight.dtype == net.stats.bias.dtype == torch.float32
    assert net.stats.running_mean.dtype == torch.float32
    for p in (net.conv.weight, net.ln.weight, net.ln.bias, net.head.weight):
        assert p.dtype == torch.bfloat16

    net = _NoBnNames()
    amp.initialize(net, opt_level="O2", keep_batchnorm_fp32=False,
                   verbosity=0).cast_params()
    assert net.stats.weight.dtype == torch.bfloat16
    assert net.stats.running_var.dtype == torch.float32     # never cast


def test_presets_build_the_bench_model_and_default_to_cuda(monkeypatch):
    from apex_tpu_torch.models import ResNet18, ResNet50, ResNet101
    counts = {cls: sum(p.numel() for p in cls(device="cpu").parameters())
              for cls in (ResNet18, ResNet50, ResNet101)}
    # torchvision's ResNet-18/50/101 parameter counts (1000 classes)
    assert counts[ResNet18] == 11_689_512
    assert counts[ResNet50] == 25_557_032
    assert counts[ResNet101] == 44_549_160
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResNet50()
