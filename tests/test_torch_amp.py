"""apex_tpu_torch.amp and apex_tpu_torch.optimizers against the JAX
package: opt-level tables, the O2 cast rule, the loss scaler's unscale and
update, FusedAdam's update with master weights and the overflow skip, and
the contracts of ``tests/test_amp.py`` (an overflow step leaves the masters
bitwise unchanged and halves the scale; the loss falls over 30 steps).

Inputs are made with numpy from a seed and handed to both sides.
Tolerances: the scaler state exactly (powers of two and counters);
unscaled gradients exactly (a multiply by a power of two); FusedAdam's
fp32 params and moments within 1e-6 relative plus 1e-9 (the same fp32
expressions, with ``beta ** step`` from two pow implementations).
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

from apex_tpu.amp import frontend as jfrontend
from apex_tpu.amp import properties as jprops
from apex_tpu.amp import scaler as jscaler
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu_torch import amp
from apex_tpu_torch.amp import properties as tprops
from apex_tpu_torch.amp import scaler as tscaler
from apex_tpu_torch.optimizers import FusedAdam, FusedAdamW
from apex_tpu_torch.utils import split_like


def test_opt_level_tables_match_jax():
    for level in ("O0", "O2", "O3"):
        for half in ("bfloat16", "float16"):
            jp = jprops.Properties()
            jp.half_dtype = getattr(jnp, half)
            jp = jprops.opt_levels[level](jp)
            tp = tprops.Properties()
            tp.half_dtype = getattr(torch, half)
            tp = tprops.opt_levels[level](tp)
            for key in ("opt_level", "keep_batchnorm_fp32", "master_weights",
                        "loss_scale", "cast_ops"):
                assert getattr(tp, key) == getattr(jp, key), (level, key)
            assert str(tp.cast_model_type).split(".")[-1] == \
                jnp.dtype(jp.cast_model_type).name
    # bf16 O2 defaults to a static scale of 1.0, fp16 O2 to dynamic
    tp = tprops.opt_levels["O2"](tprops.Properties())
    assert tp.loss_scale == 1.0


def test_unported_levels_and_options_raise():
    mod = nn.Linear(2, 2)
    for level in ("O1", "O4"):
        with pytest.raises(NotImplementedError, match=level):
            amp.initialize(mod, FusedAdam(), opt_level=level, verbosity=0)
    # zero= is ported (the ZeRO slice): it wraps the model instead
    from apex_tpu_torch.zero import ZeroShardedModel
    opt = FusedAdam()
    zm, _ = amp.initialize(mod, opt, opt_level="O2", zero=True, verbosity=0)
    assert isinstance(zm, ZeroShardedModel) and opt._zero_model is zm
    with pytest.raises(NotImplementedError, match="O4"):
        amp.make_train_step(lambda m: m, FusedAdam(), fp8=True)


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(4, 8)
        self.batchnorm = nn.BatchNorm1d(8)
        self.ln = nn.LayerNorm(8)
        self.head = nn.Linear(8, 2)


def test_o2_cast_rule_matches_jax():
    """Only batchnorm-named parameters stay fp32 under O2; LayerNorm ones
    are cast, as in the JAX package."""
    net = _Net()
    tree = {}
    for name, p in net.named_parameters():
        node = tree
        *scopes, leaf = name.split(".")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = jnp.asarray(p.detach().numpy())
    jmodel = jfrontend.AmpModel(lambda p, x: x,
                                jprops.opt_levels["O2"](jprops.Properties()))
    jcast = jmodel.cast_params(tree)
    amp_model, _ = amp.initialize(net, FusedAdam(), opt_level="O2",
                                  verbosity=0)
    assert amp_model.cast_params() is net
    for name, p in net.named_parameters():
        node = jcast
        for s in name.split("."):
            node = node[s]
        assert str(p.dtype).split(".")[-1] == jnp.dtype(node.dtype).name, name
    assert net.batchnorm.weight.dtype == torch.float32
    assert net.ln.weight.dtype == torch.bfloat16


def _state_pair(scale, unskipped=0):
    return (jscaler.ScalerState(jnp.float32(scale), jnp.int32(unskipped),
                                jnp.asarray(False)),
            tscaler.ScalerState(torch.tensor(scale, dtype=torch.float32),
                                torch.tensor(unskipped, dtype=torch.int32),
                                torch.tensor(False)))


@pytest.mark.parametrize("dynamic", [True, False])
def test_scaler_update_matches_jax(dynamic):
    kw = dict(dynamic=dynamic, scale_factor=2.0, scale_window=3,
              min_loss_scale=4.0, max_loss_scale=64.0)
    js, ts = _state_pair(16.0)
    flags = [False, False, False, False, False, False, True, True, True,
             True, False, False, False]
    for f in flags:
        js = jscaler.update(js, jnp.asarray(f), **kw)
        ts = tscaler.update(ts, torch.tensor(f), **kw)
        assert float(ts.loss_scale) == float(js.loss_scale)
        assert int(ts.unskipped) == int(js.unskipped)
        assert bool(ts.overflow) == bool(js.overflow) == f
    if dynamic:   # 16 -> 64 (max clamp) -> 4 (min clamp) -> 8
        assert float(ts.loss_scale) == 8.0


def test_unscale_matches_jax():
    rng = np.random.RandomState(0)
    grads = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(
        np.float32)]
    js, ts = _state_pair(256.0)
    jg, jinf = jscaler.unscale([jnp.asarray(g).astype(jnp.bfloat16)
                                for g in grads], js)
    tgrads = [torch.from_numpy(g).to(torch.bfloat16) for g in grads]
    flat, tinf = tscaler.unscale(tgrads, ts)
    assert bool(tinf) == bool(jinf) is False
    assert flat.dtype == torch.float32 and flat.shape == (17,)
    for a, b in zip(split_like(flat, tgrads), jg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for bad in (np.inf, np.nan):
        g = grads[1].copy()
        g[2] = bad
        _, jinf = jscaler.unscale([jnp.asarray(g)], js)
        _, tinf = tscaler.unscale([torch.from_numpy(g)], ts)
        assert bool(tinf) == bool(jinf) is True


def _adam_pair(kind, master):
    kw = dict(lr=1e-2, weight_decay=0.1 if kind != "plain" else 0.0,
              adam_w_mode=kind != "l2")
    return JFusedAdam(master_weights=master, **kw), FusedAdam(
        master_weights=master, **kw)


@pytest.mark.parametrize("kind", ["plain", "adamw", "l2"])
@pytest.mark.parametrize("master", [False, True])
def test_fused_adam_matches_jax(kind, master):
    rng = np.random.RandomState(1)
    shapes = [(4, 3), (7,), (2, 2, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    jopt, topt = _adam_pair(kind, master)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for step in range(3):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        skip = step == 1
        jp, jstate = jopt.apply(jstate, jp, [jnp.asarray(g) for g in grads],
                                skip=jnp.asarray(skip))
        _, tstate = topt.apply(tstate, tp, [torch.from_numpy(g)
                                            for g in grads],
                               skip=torch.tensor(skip))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
        assert int(tstate.groups[0].step) == int(jstate.groups[0].step)
    jm = jstate.groups[0].slots["exp_avg"]
    tm = split_like(tstate.groups[0].slots["exp_avg"], tp)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)


def test_fused_adam_skip_is_bitwise_and_master_feeds_half_params():
    p = [torch.randn(5, 3).to(torch.bfloat16), torch.randn(4)
         .to(torch.bfloat16)]
    opt = FusedAdamW(lr=1e-2, master_weights=True)
    state = opt.init(p)
    assert state.groups[0].master.dtype == torch.float32
    g = [torch.randn(5, 3), torch.randn(4)]
    _, state = opt.apply(state, p, g, skip=torch.tensor(False))
    for t, m in zip(p, opt.master_params(state)):
        assert torch.equal(t, m.to(torch.bfloat16))
    snap = (state.groups[0].master.clone(),
            {k: v.clone() for k, v in state.groups[0].slots.items()},
            [t.clone() for t in p])
    bad = [torch.full((5, 3), float("nan")), torch.randn(4)]
    _, state2 = opt.apply(state, p, bad, skip=torch.tensor(True))
    assert torch.equal(state2.groups[0].master, snap[0])
    for k, v in snap[1].items():
        assert torch.equal(state2.groups[0].slots[k], v)
    assert int(state2.groups[0].step) == 1
    for t, s in zip(p, snap[2]):
        assert torch.equal(t, s)


def test_apply_flat_matches_apply_over_groups():
    """``apply_flat`` on one flat buffer over two groups steps each group on
    its slice, bitwise as ``apply`` on the per-tensor gradients; a buffer of
    the wrong size or dtype is refused."""
    rng = np.random.RandomState(3)
    shapes = [[(3, 2), (5,)], [(4,)]]
    init = [[rng.randn(*s).astype(np.float32) for s in g] for g in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in g] for g in shapes]
    runs = []
    for flat_api in (False, True):
        ps = [[torch.from_numpy(a.copy()) for a in g] for g in init]
        opt = FusedAdam(ps[0], lr=1e-2)
        opt.add_param_group({"params": ps[1], "lr": 1e-1})
        state = opt.init()
        gs = [[torch.from_numpy(a) for a in g] for g in grads]
        if flat_api:
            flat = torch.cat([g.reshape(-1) for grp in gs for g in grp])
            state = opt.apply_flat(state, flat, skip=torch.tensor(False))
            with pytest.raises(ValueError, match="flat gradients"):
                opt.apply_flat(state, flat[:-1])
            with pytest.raises(ValueError, match="flat gradients"):
                opt.apply_flat(state, flat.double())
        else:
            _, state = opt.apply(state, ps, gs, skip=torch.tensor(False))
        runs.append((ps, state))
    (pa, sa), (pb, sb) = runs
    for a, b in zip(sum(pa, []), sum(pb, [])):
        assert torch.equal(a, b)
    for ga, gb in zip(sa.groups, sb.groups):
        assert int(ga.step) == int(gb.step) == 1
        for k in ga.slots:
            assert torch.equal(ga.slots[k], gb.slots[k])


class _MLP(nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w1 = nn.Parameter(torch.randn(4, 16, generator=g) * 0.5)
        self.w2 = nn.Parameter(torch.randn(16, 2, generator=g) * 0.5)

    def forward(self, x):
        return torch.tanh(x @ self.w1) @ self.w2


def _mlp_setup(lr, half=torch.bfloat16):
    net = _MLP()
    model, opt = amp.initialize(net, FusedAdam(lr=lr), opt_level="O2",
                                half_dtype=half, verbosity=0)
    model.cast_params()
    return net, model, opt, opt.init(net.parameters())


def test_train_step_decreases_loss():
    net, model, opt, state = _mlp_setup(5e-2)
    x = torch.from_numpy(np.random.RandomState(0).randn(16, 4).astype(
        np.float32))
    y = torch.from_numpy(np.random.RandomState(1).randn(16, 2).astype(
        np.float32))

    def loss_fn(m, x, y):
        return ((model(x) - y) ** 2).mean()

    step = amp.make_train_step(loss_fn, opt)
    sstate, losses = opt._scaler.state, []
    for _ in range(30):
        _, state, sstate, loss = step(net, state, sstate, x, y)
        assert loss.dtype == torch.float32 and loss.dim() == 0
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5


def test_train_step_overflow_skips_and_rescales():
    net, model, opt, state = _mlp_setup(0.1, half=torch.float16)
    assert opt._scaler.dynamic

    def loss_fn(m, x):
        # overflow factory: the gradients grow far past the fp16 range
        return (m.w1.float() * 1e30).sum() * x.sum()

    step = amp.make_train_step(loss_fn, opt)
    x = torch.ones(2)
    before = [p.detach().clone() for p in net.parameters()]
    master = state.groups[0].master.clone()
    s0 = float(opt._scaler.state.loss_scale)
    _, state, sstate, _ = step(net, state, opt._scaler.state, x)
    for p, b in zip(net.parameters(), before):
        assert torch.equal(p, b)
    assert torch.equal(state.groups[0].master, master)
    assert float(sstate.loss_scale) == s0 / 2


def test_scaler_state_dict_roundtrip():
    net = _MLP()
    amp.initialize(net, FusedAdam(), opt_level="O2", loss_scale="dynamic",
                   verbosity=0)
    sd = amp.state_dict()
    assert sd["loss_scaler0"]["loss_scale"] == 2.0 ** 16
    sd["loss_scaler0"]["loss_scale"] = 42.0
    amp.load_state_dict(sd)
    from apex_tpu_torch.amp._amp_state import _amp_state
    assert _amp_state.loss_scalers[0].loss_scale() == 42.0


def test_jax_reference_tree_helpers_agree():
    """``tree_all_finite`` over tensors as the JAX package's over arrays."""
    from apex_tpu.utils.tree import tree_all_finite as jall
    from apex_tpu_torch.utils import tree_all_finite as tall
    a = np.ones(3, np.float32)
    b = np.array([1.0, np.inf], np.float32)
    for leaves in ([a], [a, b], [np.array([np.nan], np.float32)]):
        assert bool(tall([torch.from_numpy(x) for x in leaves])) == \
            bool(jall([jnp.asarray(x) for x in leaves]))


def test_param_groups_match_jax_and_drive_the_train_step():
    """Two param groups with their own lr: ``apply`` against the JAX
    package's multi-group apply, then ``make_train_step`` over them."""
    rng = np.random.RandomState(2)
    a, b = rng.randn(3, 2).astype(np.float32), rng.randn(4).astype(
        np.float32)
    ga, gb = rng.randn(3, 2).astype(np.float32), rng.randn(4).astype(
        np.float32)
    jopt = JFusedAdam([jnp.asarray(a)], lr=1e-2)
    jopt.add_param_group({"params": [jnp.asarray(b)], "lr": 1e-1})
    ta, tb = torch.from_numpy(a.copy()), torch.from_numpy(b.copy())
    topt = FusedAdam([ta], lr=1e-2)
    topt.add_param_group({"params": [tb], "lr": 1e-1})
    jstate = jopt.init()
    tstate = topt.init()
    jp, _ = jopt.apply(jstate, [[jnp.asarray(a)], [jnp.asarray(b)]],
                       [[jnp.asarray(ga)], [jnp.asarray(gb)]])
    topt.apply(tstate, [[ta], [tb]], [[torch.from_numpy(ga)],
                                      [torch.from_numpy(gb)]])
    np.testing.assert_allclose(ta.numpy(), np.asarray(jp[0][0]), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jp[1][0]), rtol=1e-6)

    net = _MLP()
    opt = FusedAdam([net.w1], lr=1e-2)
    opt.add_param_group({"params": [net.w2], "lr": 0.0})
    _, opt = amp.initialize(net, opt, opt_level="O0", verbosity=0)
    state = opt.init()
    w1, w2 = net.w1.detach().clone(), net.w2.detach().clone()
    step = amp.make_train_step(lambda m, x: m(x).square().mean(), opt)
    _, state, _, _ = step(net, state, opt._scaler.state, torch.ones(3, 4))
    assert not torch.equal(net.w1, w1)          # lr 1e-2 moved it
    assert torch.equal(net.w2, w2)              # lr 0 kept it
    assert [int(g.step) for g in state.groups] == [1, 1]
