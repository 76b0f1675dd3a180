"""The port's ZeRO (``apex_tpu_torch.zero``, ``contrib.optimizers``,
``utils.flat``) against the JAX package in one process, at world 1 and on
single-process layouts of worlds 2-4.

Inputs are made with numpy from a seed; the JAX side runs as its own CPU
tests run it (the fused update's Pallas kernel in interpret mode at
``block_n=1024``, ``shard_map`` over the forced host devices), the port
through its kernels' plain versions on CPU tensors.

Tolerances and their reasons:

- rules, layouts, shards and the flat buffer: exact;
- the update math: the port is bitwise the op-by-op fp32 sequence (each
  operation rounded once, as numpy computes it). XLA contracts the
  moment updates and the final axpy into fused multiply-adds (the JAX
  module documents the axpy), so against JAX m, v and p/upd are held
  within two fp32 ulps of the largest value of each output (read: at most
  8e-8 of it, under the 2.4e-7 limit);
- the ZeRO-3 O2 GPT step against JAX: as the dense O2 step of
  ``test_torch_train.py`` — losses within 2e-2 (bf16 activations,
  products summed in other orders), fp32 masters within 2 * lr per step
  (a near-zero gradient whose sign differs moves an Adam master by lr on
  each side) with at most 2 % of the elements more than lr / 2 apart, m
  and v within 5 % relative norm (the bf16 gradients differ by their
  roundings), step and scaler state exactly;
- the port's ZeRO-3 step at world 1 against the port's dense FusedAdam
  step from the same fp32 init: bitwise (the same plain ops).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu import zero as jzero
from apex_tpu._compat import shard_map
from apex_tpu.models.gpt import GPT as JGPT
from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.transformer import parallel_state as ps
from apex_tpu.utils.flat import FlatBuffer as JFlatBuffer
from apex_tpu.zero import update as jupd
from apex_tpu.zero.fused_update import fused_shard_update as jfused
from apex_tpu_torch import amp, zero
from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                               DistributedFusedLAMB)
from apex_tpu_torch.models.gpt import GPT, GPTConfig
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils.flat import (FlatBuffer, flatten_tensors,
                                       unflatten_tensors)
from apex_tpu_torch.zero import core, update as tupd
from apex_tpu_torch.zero.fused_update import (fused_shard_update,
                                              fused_shard_update_reference)

SHAPE = dict(vocab_size=256, max_seq_len=32, hidden_size=64, num_layers=2,
             num_heads=4)
B, S = 2, 32
LR = 1e-3
ULP2 = 2.0 ** -22          # two fp32 ulps, relative


@pytest.fixture(scope="module")
def jparams():
    ps.destroy_model_parallel()
    cfg = JGPTConfig(dtype=jnp.float32, **SHAPE)
    return jax.device_get(JGPT(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


def _flat_names(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_names(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_leaf_names(tree):
    """Dotted names of a JAX tree's leaves in ``jax.tree.flatten`` order
    (dict keys sorted: the order of the JAX package's flat buffers)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [".".join(str(k.key) for k in path) for path, _ in flat]


def _jax_flat_by_name(flat, tree):
    """A JAX flat buffer over ``tree`` split back into leaves by name."""
    jfb = JFlatBuffer.from_tree(tree)
    flat = np.asarray(flat)
    return {k: flat[o:o + n] for k, o, n in
            zip(_jax_leaf_names(tree), jfb.offsets, jfb.sizes)}


def _port_tree(jparams):
    """The port's ``name -> tensor`` tree of the same GPT (fp32)."""
    model = GPT.params_from_jax(GPTConfig(dtype=torch.float32, **SHAPE),
                                jparams, device="cpu")
    return {k: p.detach() for k, p in model.named_parameters()}


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("data",))


# ---------------------------------------------------------------------------
# utils/flat.py
# ---------------------------------------------------------------------------


def test_flat_buffer_matches_jax(jparams):
    tree = _port_tree(jparams)
    jflat = JFlatBuffer.from_tree(jparams)
    flat = FlatBuffer.from_tree(tree)
    # flax orders a dict's keys sorted; the port keeps module order, so
    # compare the layout leaf by leaf through the names
    jnames = _jax_leaf_names(jparams)
    jlay = dict(zip(jnames, zip(jflat.sizes, jflat.shapes)))
    assert flat.total == jflat.total
    for name, size, shape in zip(flat.names, flat.sizes, flat.shapes):
        assert jlay[name] == (size, shape), name
    packed = flat.pack(tree)
    assert packed.dtype == torch.float32 and packed.numel() == flat.total
    back = flat.unpack(packed)
    assert list(back) == list(tree)
    for k in tree:
        assert torch.equal(back[k], tree[k])
    half = flat.pack(tree, dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16


def test_flatten_unflatten_round_trip():
    rng = np.random.RandomState(0)
    ts = [torch.from_numpy(rng.randn(*s).astype(np.float32))
          for s in ((3, 4), (5,), (2, 2, 2))]
    flat = flatten_tensors(ts)
    assert flat.shape == (12 + 5 + 8,)
    for a, b in zip(unflatten_tensors(flat, ts), ts):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

RULES = [
    dict(rules=None, min_shard_size=2 ** 11),
    dict(rules=None, min_shard_size=8),
    dict(rules=(("ln|bias", "replicate"), ("wte", "replicate"),
                (".*", "shard")), min_shard_size=1),
]


@pytest.mark.parametrize("cfg", RULES, ids=["default", "min8", "table"])
def test_match_zero_rules_matches_jax(jparams, cfg):
    got = zero.match_zero_rules(cfg["rules"], _port_tree(jparams),
                                min_shard_size=cfg["min_shard_size"])
    ref = _flat_names(jax.tree.map(
        lambda b: np.asarray(b), jzero.match_zero_rules(
            cfg["rules"], jparams, min_shard_size=cfg["min_shard_size"],
            validate=False)))
    assert set(got) == set(ref)
    for k in got:
        assert got[k] == bool(ref[k]), k
    # the default threshold replicates the 64-wide biases and norms;
    # min 8 shards every leaf; the table replicates by name
    assert any(got.values())
    assert all(got.values()) == (cfg["min_shard_size"] == 8)


def test_match_zero_rules_errors(jparams):
    tree = _port_tree(jparams)
    with pytest.raises(ValueError, match="no zero sharding rule"):
        zero.match_zero_rules((("kernel", "shard"),), tree, min_shard_size=1)
    with pytest.raises(ValueError, match="decision"):
        zero.match_zero_rules(((".*", "sharded"),), tree)
    ints = {"step": torch.zeros((), dtype=torch.int32),
            "w": torch.zeros(4096)}
    assert zero.match_zero_rules(None, ints) == {"step": False, "w": True}


# ---------------------------------------------------------------------------
# spec layout and shard/gather
# ---------------------------------------------------------------------------


def _jax_spec_and_shards(jparams, world, min_shard_size):
    """The JAX spec at ``world`` and each sharded leaf's per-rank shards
    concatenated in rank order (``out_specs=P("data")``)."""
    box = {}
    zm = jzero.ZeroShardedModel(lambda p, x: x, min_shard_size=min_shard_size)

    def run(p):
        shards = zm.shard(p)
        box["spec"] = zm.spec
        return shards

    dec = jzero.match_zero_rules(None, jparams,
                                 min_shard_size=min_shard_size)
    outs = jax.tree.map(lambda d: P("data") if (d and world > 1) else P(),
                        dec)
    shards = jax.jit(shard_map(run, mesh=_mesh(world), in_specs=(P(),),
                               out_specs=outs, check_vma=False))(jparams)
    return box["spec"], _flat_names(jax.device_get(shards))


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_spec_layout_matches_jax(jparams, world):
    jspec, _ = _jax_spec_and_shards(jparams, world, 100)
    tree = _port_tree(jparams)
    spec = core.build_spec(tree, world=world, min_shard_size=100)
    jnames = _jax_leaf_names(jparams)
    order = [jnames.index(k) for k in spec.names]
    for attr in ("sharded", "padded", "sizes"):
        ref = getattr(jspec, attr)
        assert tuple(getattr(spec, attr)) == tuple(ref[i] for i in order), \
            attr
    assert [spec.shard_len(i) for i in range(spec.n_leaves)] == \
        [jspec.shard_len(i) for i in order]
    # local offsets follow each package's own leaf order: compare the
    # running sums over the same leaves
    ref = {jnames[i]: jspec.shard_len(i) for i in range(jspec.n_leaves)
           if jspec.sharded[i]}
    acc = 0
    for i, k in enumerate(spec.names):
        assert spec.local_offsets()[i] == acc
        acc += ref.get(k, 0)
    assert core.params_resident_bytes(spec) == sum(
        (spec.shard_len(i) if spec.sharded[i] else spec.sizes[i]) * 4
        for i in range(spec.n_leaves))
    if world > 1:
        assert any(spec.sharded) and not all(spec.sharded)
    if world == 3:         # total % world != 0: padded tails
        assert any(s % world for s in spec.sizes)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_shard_tree_matches_jax_and_round_trips(jparams, world):
    _, jshards = _jax_spec_and_shards(jparams, world, 100)
    tree = _port_tree(jparams)
    spec = core.build_spec(tree, world=world, min_shard_size=100)
    ranks = [core.shard_tree(tree, spec, rank=r) for r in range(world)]
    for i, k in enumerate(spec.names):
        if spec.sharded[i]:
            got = torch.cat([t[k] for t in ranks]).numpy()
            assert all(t[k].shape == (spec.shard_len(i),) for t in ranks)
        else:
            got = ranks[0][k].numpy()
        np.testing.assert_array_equal(got, jshards[k], err_msg=k)
    back = core.assemble_tree(ranks, spec)
    for k in tree:
        assert torch.equal(back[k], tree[k]), k


def test_world1_shards_nothing_and_gathers_identity(jparams):
    tree = _port_tree(jparams)
    spec = core.build_spec(tree)
    assert spec.world == 1 and not any(spec.sharded)
    shards = core.zero_shard(tree, spec)
    full = core.zero_gather(shards, spec)
    for k in tree:
        assert torch.equal(full[k], tree[k])


# ---------------------------------------------------------------------------
# update math and the fused update
# ---------------------------------------------------------------------------

CASES = [(kind, wd, aw, bc) for kind in ("adam", "lamb")
         for wd in (0.0, 0.01) for aw in (True, False) for bc in (True, False)]
CASE_IDS = [f"{k}-wd{wd}-{'adamw' if aw else 'l2'}-{'bc' if bc else 'nobc'}"
            for k, wd, aw, bc in CASES]


def _inputs(n=5000, seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n) * 0.05).astype(np.float32),
            (rng.randn(n) * 0.01).astype(np.float32),
            (rng.randn(n) * 1e-3).astype(np.float32),
            (np.abs(rng.randn(n)) * 1e-4).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _hyper(wd, aw, bc):
    return dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=wd,
                adam_w_mode=aw, bias_correction=bc)


def _port_math(kind, p, g, m, v, step, hyper, grad_averaging=True):
    st = torch.tensor(step, dtype=torch.int32)
    if kind == "adam":
        return tupd.adam_shard_step(_t(p), _t(g), _t(m), _t(v), st, lr=LR,
                                    **hyper)
    return tupd.lamb_shard_term(_t(p), _t(g), _t(m), _t(v), st,
                                grad_averaging=grad_averaging, **hyper)


def _close_to_jax(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    err = float(np.abs(got - ref).max())
    assert err <= ULP2 * float(np.abs(ref).max()), f"{what}: {err}"


@pytest.mark.parametrize("kind,wd,aw,bc", CASES, ids=CASE_IDS)
def test_update_is_the_op_by_op_fp32_sequence(kind, wd, aw, bc):
    p, g, m, v = _inputs()
    f = np.float32
    out = _port_math(kind, p, g, m, v, 7, _hyper(wd, aw, bc))
    if not aw and wd:
        g = (g + f(wd) * p).astype(f)
    beta3 = f(1 - 0.9)
    m2 = (f(0.9) * m + beta3 * g).astype(f)
    v2 = (f(0.999) * v + (f(1 - 0.999) * g) * g).astype(f)
    if bc:
        c1, c2 = (np.float32(c) for c in tupd.bias_corrections(
            torch.tensor(7), (0.9, 0.999)))
        m_hat, v_hat = m2 / c1, v2 / c2
    else:
        m_hat, v_hat = m2, v2
    # torch's CPU sqrt is not always correctly rounded (numpy's and
    # CUDA's are): take it from torch, every other operation from numpy
    root = torch.sqrt(torch.from_numpy(np.ascontiguousarray(v_hat))).numpy()
    upd = (m_hat / (root + f(1e-8))).astype(f)
    if aw and wd:
        upd = (upd + f(wd) * p).astype(f)
    np.testing.assert_array_equal(out[1].numpy(), m2)
    np.testing.assert_array_equal(out[2].numpy(), v2)
    want = upd if kind == "lamb" else (p - f(LR) * upd).astype(f)
    np.testing.assert_array_equal(out[0].numpy(), want)


@pytest.mark.parametrize("kind,wd,aw,bc", CASES, ids=CASE_IDS)
def test_update_matches_jax(kind, wd, aw, bc):
    p, g, m, v = _inputs(seed=1)
    hyper = _hyper(wd, aw, bc)
    if kind == "adam":
        ref = jax.jit(lambda *a: jupd.adam_shard_step(*a, lr=LR, **hyper))(
            p, g, m, v, jnp.int32(7))
    else:
        ref = jax.jit(lambda *a: jupd.lamb_shard_term(
            *a, grad_averaging=True, **hyper))(p, g, m, v, jnp.int32(7))
    got = _port_math(kind, p, g, m, v, 7, hyper)
    for name, a, r in zip(("p/upd", "m", "v"), got, ref):
        _close_to_jax(a.numpy(), r, name)


# grad_averaging (LAMB's beta3) on and off for LAMB; Adam ignores it
FUSED = [(*c, True) for c in CASES] + [(*c, False) for c in CASES
                                       if c[0] == "lamb"]
FUSED_IDS = CASE_IDS + [i + "-no_avg" for c, i in zip(CASES, CASE_IDS)
                        if c[0] == "lamb"]


@pytest.mark.parametrize("kind,wd,aw,bc,grad_averaging", FUSED,
                         ids=FUSED_IDS)
def test_fused_update_matches_jax_interpret(kind, wd, aw, bc,
                                            grad_averaging):
    p, g, m, v = _inputs(n=5003, seed=2)        # ragged: JAX pads
    hyper = _hyper(wd, aw, bc)
    ref = jax.jit(lambda *a: jfused(
        *a, kind=kind, lr=LR, block_n=1024, interpret=True,
        grad_averaging=grad_averaging, **hyper))(p, g, m, v, jnp.int32(3))
    tp, tm, tv = _t(p), _t(m), _t(v)
    n0 = (fused_shard_update.launches, fused_shard_update.lamb_launches)
    out = fused_shard_update(tp, _t(g), tm, tv,
                             torch.tensor(3, dtype=torch.int32), kind=kind,
                             lr=LR, grad_averaging=grad_averaging, **hyper)
    assert (fused_shard_update.launches,
            fused_shard_update.lamb_launches) == n0      # CPU: no kernel
    # in place: m, v always; p in Adam mode; LAMB returns a new upd
    assert out[1] is tm and out[2] is tv
    assert (out[0] is tp) == (kind == "adam")
    for name, a, r in zip(("p/upd", "m", "v"), out, ref):
        _close_to_jax(a.numpy(), r, name)


@pytest.mark.parametrize("kind", ["adam", "lamb"])
def test_fused_update_skip_is_bitwise(kind):
    p, g, m, v = _inputs(n=1001, seed=3)
    tp, tm, tv = _t(p), _t(m), _t(v)
    out = fused_shard_update(tp, _t(g), tm, tv, torch.tensor(1), kind=kind,
                             lr=LR, skip=torch.tensor(True),
                             **_hyper(0.01, True, True))
    np.testing.assert_array_equal(tp.numpy(), p)
    np.testing.assert_array_equal(tm.numpy(), m)
    np.testing.assert_array_equal(tv.numpy(), v)
    if kind == "lamb":
        assert not bool(out[0].any())
    ref = fused_shard_update_reference(
        _t(p), _t(g), _t(m), _t(v), torch.tensor(1), kind=kind, lr=LR,
        skip=torch.tensor(False), **_hyper(0.01, True, True))
    got = fused_shard_update(tp, _t(g), tm, tv, torch.tensor(1), kind=kind,
                             lr=LR, skip=torch.tensor(False),
                             **_hyper(0.01, True, True))
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


@pytest.mark.parametrize("knob", ["block_n", "interpret", "autotune"])
def test_fused_update_tuner_knobs_raise(knob):
    z = torch.zeros(8)
    with pytest.raises(NotImplementedError, match="A14"):
        fused_shard_update(z, z, z, z, torch.tensor(1), kind="adam", lr=LR,
                           **_hyper(0.0, True, True), **{knob: 1024})
    with pytest.raises(ValueError, match="kind"):
        fused_shard_update(z, z, z, z, torch.tensor(1), kind="sgd", lr=LR,
                           **_hyper(0.0, True, True))


@pytest.mark.parametrize("w,u,nvlamb,wd", [
    ([0.0, 2.0, 3.0], [1.0, 0.0, 1.5], False, 0.01),
    ([0.0, 2.0, 3.0], [1.0, 0.0, 1.5], True, 0.0),
    ([1.0, 2.0], [4.0, 1e-31], False, 0.0),
    ([1.0, 2.0], [4.0, 1e-31], True, 0.01),
])
def test_lamb_trust_ratio_matches_jax(w, u, nvlamb, wd):
    w = np.asarray(w, np.float32)
    u = np.asarray(u, np.float32)
    ref = jupd.lamb_trust_ratio(jnp.asarray(w), jnp.asarray(u),
                                use_nvlamb=nvlamb, weight_decay=wd)
    got = tupd.lamb_trust_ratio(_t(w), _t(u), use_nvlamb=nvlamb,
                                weight_decay=wd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# the ZeRO-3 O2 step at world 1
# ---------------------------------------------------------------------------


def _batch(seed):
    ids = np.random.RandomState(seed).randint(
        0, SHAPE["vocab_size"], (B, S)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _jax_zero3_o2(jparams, ids, labels, steps):
    gpt = JGPT(JGPTConfig(dtype=jnp.bfloat16, **SHAPE))
    opt = jzero.ZeroOptimizer(lr=LR, kind="adam", shard_params=True,
                              weight_decay=0.01)
    model, opt = jamp.initialize(gpt, opt, opt_level="O2",
                                 loss_scale="dynamic", verbosity=0,
                                 zero=True)
    step = jzero.make_train_step(
        lambda full, i, l: gpt.loss({"params": full}, i, l), optimizer=opt,
        donate=False)
    scaler = opt._amp_stash.loss_scalers[0]

    def run(p, i, l):
        shards32 = model.shard(p)
        st = opt.init(shards32, model.spec)
        shards = model.cast_params(shards32)
        ss, losses = scaler.state, []
        for _ in range(steps):
            shards, st, ss, loss = step(shards, st, ss, i, l)
            losses.append(loss)
        return jnp.stack(losses), st, ss

    params = jax.tree.map(jnp.asarray, jparams)
    losses, st, ss = jax.jit(shard_map(
        run, mesh=_mesh(1), in_specs=(P(), P(), P()),
        out_specs=(P(), P(), P()), check_vma=False))(
            params, jnp.asarray(ids), jnp.asarray(labels))
    return (np.asarray(losses), jax.device_get(st), jax.device_get(ss))


def _port_zero3_o2(jparams, steps, ids=None, labels=None, kind="adam"):
    model = GPT.params_from_jax(GPTConfig(dtype=torch.bfloat16, **SHAPE),
                                jparams, device="cpu")
    for p in model.parameters():
        p.data = p.data.float()
    opt = zero.ZeroOptimizer(lr=LR, kind=kind, shard_params=True,
                             weight_decay=0.01)
    zm, opt = amp.initialize(model, opt, opt_level="O2",
                             loss_scale="dynamic", verbosity=0, zero=True)
    st = opt.init(zm.shard(), zm.spec)
    shards = zm.cast_params(zm.shard())
    step = zero.make_train_step(lambda m, i, l: m.loss(i, l), optimizer=opt)
    ss, losses = opt._scaler.state, []
    for _ in range(steps):
        shards, st, ss, loss = step(shards, st, ss, torch.from_numpy(ids),
                                    torch.from_numpy(labels))
        losses.append(float(loss))
    return zm, opt, step, shards, st, ss, losses


def test_zero3_o2_gpt_steps_match_jax(jparams):
    ids, labels = _batch(2)
    steps = 3
    jl, jst, jss = _jax_zero3_o2(jparams, ids, labels, steps)
    zm, _, _, shards, st, ss, tl = _port_zero3_o2(jparams, steps, ids,
                                                 labels)
    assert isinstance(zm, zero.ZeroShardedModel)
    assert {x.dtype for x in shards.values()} == {torch.bfloat16}
    np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=0)
    assert int(st.step) == int(jst.step) == steps
    jm = {k: _flat_names(getattr(jst, k)) for k in ("master", "m", "v")}
    far = total = 0
    for name in zm.spec.names:
        mast = st.master[name].numpy()
        assert st.master[name].dtype == torch.float32
        diff = np.abs(mast - jm["master"][name])
        assert float(diff.max()) <= 2 * LR * steps + 2.0 ** -23, name
        far += int((diff > LR / 2).sum())
        total += diff.size
        # the resident bf16 shard is the master cast down
        assert torch.equal(shards[name], st.master[name].to(torch.bfloat16))
        for slot in ("m", "v"):
            got = getattr(st, slot)[name].numpy()
            ref = jm[slot][name]
            rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
            assert rel <= 5e-2, (slot, name, rel)
    assert far <= 0.02 * total, far / total
    assert float(ss.loss_scale) == float(jss.loss_scale) == 2.0 ** 16
    assert int(ss.unskipped) == int(jss.unskipped) == steps
    assert bool(ss.overflow) is False


def test_zero3_o2_overflow_skips_bitwise(jparams):
    ids, labels = _batch(4)
    zm, opt, _, shards, st, ss, _ = _port_zero3_o2(jparams, 1, ids, labels)
    before = ({k: v.clone() for k, v in shards.items()},
              st.master.flat.clone(), st.m.flat.clone(), st.v.flat.clone(),
              int(st.step))
    big = zero.make_train_step(lambda m, i, l: m.loss(i, l) * 1e38,
                               optimizer=opt)
    sh2, st2, ss2, _ = big(shards, st, ss, torch.from_numpy(ids),
                           torch.from_numpy(labels))
    for k, v in before[0].items():
        assert torch.equal(sh2[k], v), k
    assert torch.equal(st2.master.flat, before[1])
    assert torch.equal(st2.m.flat, before[2])
    assert torch.equal(st2.v.flat, before[3])
    assert int(st2.step) == before[4] == 1
    assert float(ss2.loss_scale) == float(ss.loss_scale) / 2
    assert bool(ss2.overflow) and int(ss2.unskipped) == 0


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_zero3_world1_is_bitwise_the_dense_fused_adam(jparams, wd):
    """World 1 shards nothing: the ZeRO-3 step through the fused update's
    plain version is the dense FusedAdam step, bit for bit, when both
    masters start from the same fp32 values."""
    ids, labels = _batch(5)
    cfg = GPTConfig(dtype=torch.bfloat16, **SHAPE)
    t_ids, t_lab = torch.from_numpy(ids), torch.from_numpy(labels)

    def fp32_model():
        m = GPT.params_from_jax(cfg, jparams, device="cpu")
        for p in m.parameters():
            p.data = p.data.float()
        return m

    model = fp32_model()
    zm, opt = amp.initialize(
        model, zero.ZeroOptimizer(lr=LR, weight_decay=wd), opt_level="O2",
        loss_scale="dynamic", verbosity=0, zero=True)
    st = opt.init(zm.shard(), zm.spec)
    shards = zm.cast_params(zm.shard())
    step = zero.make_train_step(lambda m, i, l: m.loss(i, l), optimizer=opt)
    dense = fp32_model()
    am, dopt = amp.initialize(dense, FusedAdam(lr=LR, weight_decay=wd),
                              opt_level="O2", loss_scale="dynamic",
                              verbosity=0)
    dstate = dopt.init(dense.parameters())        # fp32 masters first
    am.cast_params()
    dstep = amp.make_train_step(lambda m, i, l: m.loss(i, l), dopt)
    ss, dss = opt._scaler.state, dopt._scaler.state
    for _ in range(3):
        shards, st, ss, loss = step(shards, st, ss, t_ids, t_lab)
        _, dstate, dss, dloss = dstep(dense, dstate, dss, t_ids, t_lab)
        assert float(loss) == float(dloss)
    g = dstate.groups[0]
    assert torch.equal(st.master.flat, g.master)
    assert torch.equal(st.m.flat, g.slots["exp_avg"])
    assert torch.equal(st.v.flat, g.slots["exp_avg_sq"])
    for (name, p), k in zip(dense.named_parameters(), zm.spec.names):
        assert name == k and torch.equal(shards[k], p)


def test_tier2_lamb_through_amp_make_train_step_matches_jax(jparams):
    """``DistributedFusedLAMB`` (tier 2) at world 1 drives the ordinary
    amp step; against the JAX class under the same O2 flow."""
    from apex_tpu.contrib.optimizers import \
        DistributedFusedLAMB as JDistributedFusedLAMB
    ids, labels = _batch(6)
    steps = 3
    gpt = JGPT(JGPTConfig(dtype=jnp.bfloat16, **SHAPE))
    jmodel, jopt = jamp.initialize(
        gpt, JDistributedFusedLAMB(lr=LR, weight_decay=0.01,
                                   max_grad_norm=1.0),
        opt_level="O2", loss_scale="dynamic", verbosity=0)
    params = jmodel.cast_params(jax.tree.map(jnp.asarray, jparams))
    jstate = jopt.init(params)
    jscaler = jopt._amp_stash.loss_scalers[0]
    jstep = jamp.make_train_step(lambda p, i, l: gpt.loss({"params": p}, i, l),
                                 jopt, scaler=jscaler, donate=False)
    jss, jl = jscaler.state, []
    for _ in range(steps):
        params, jstate, jss, loss = jstep(params, jstate, jss,
                                          jnp.asarray(ids),
                                          jnp.asarray(labels))
        jl.append(float(loss))
    model = GPT.params_from_jax(GPTConfig(dtype=torch.bfloat16, **SHAPE),
                                jparams, device="cpu")
    am, opt = amp.initialize(model, DistributedFusedLAMB(
        lr=LR, weight_decay=0.01, max_grad_norm=1.0), opt_level="O2",
        loss_scale="dynamic", verbosity=0)
    am.cast_params()
    state = opt.init(model)
    step = amp.make_train_step(lambda m, i, l: m.loss(i, l), opt)
    ss, tl = opt._scaler.state, []
    for _ in range(steps):
        _, state, ss, loss = step(model, state, ss, torch.from_numpy(ids),
                                  torch.from_numpy(labels))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=0)
    assert int(state.step) == int(jstate.step) == steps
    assert state.master_shard.shape == jstate.master_shard.shape
    jm = _jax_flat_by_name(jstate.master_shard, jparams)
    tm = opt._spec.unpack(state.master_shard, dtype_from_spec=False)
    # LAMB's step is lr * ratio * upd with |upd| <= ~1: the Adam bound
    diff = np.concatenate([np.abs(tm[k].numpy().reshape(-1) - jm[k])
                           for k in tm])
    assert float(diff.max()) <= 2 * LR * steps + 2.0 ** -23
    assert int((diff > LR / 2).sum()) <= 0.02 * diff.size
    for p, v in zip(model.parameters(), opt.param_groups[0]["params"]):
        assert p is v
    assert float(ss.loss_scale) == float(jss.loss_scale)


# ---------------------------------------------------------------------------
# initialize(zero=...)
# ---------------------------------------------------------------------------


def _tiny_model():
    return GPT.init_params(GPTConfig(dtype=torch.float32, **SHAPE),
                           torch.Generator().manual_seed(0), device="cpu")


def test_initialize_zero_rejects_two_models():
    with pytest.raises(ValueError, match="exactly one model"):
        amp.initialize([_tiny_model(), _tiny_model()],
                       zero.ZeroOptimizer(lr=LR), opt_level="O2",
                       verbosity=0, zero=True)


def test_initialize_zero_rejects_a_group_mismatch():
    other = object()          # any group that is not the zero group
    with pytest.raises(ValueError, match="group"):
        amp.initialize(_tiny_model(), zero.ZeroOptimizer(lr=LR),
                       opt_level="O2", verbosity=0,
                       zero=dict(group=other, min_shard_size=8))
    zm = zero.ZeroShardedModel(_tiny_model(), group=other)
    with pytest.raises(ValueError, match="group"):
        zero.make_train_step(lambda m, i, l: 0.0, zm,
                             zero.ZeroOptimizer(lr=LR))


def test_initialize_zero_accepts_a_model_and_survives_disabled():
    model = _tiny_model()
    zm0 = zero.ZeroShardedModel(None, min_shard_size=8)
    out, opt = amp.initialize(model, zero.ZeroOptimizer(lr=LR),
                              opt_level="O2", verbosity=0, zero=zm0)
    assert out is zm0 and zm0.module is model and opt._zero_model is zm0
    opt2 = zero.ZeroOptimizer(lr=LR)
    zm, opt2 = amp.initialize(model, opt2, False, opt_level="O2",
                              verbosity=0, zero=dict(min_shard_size=8))
    assert isinstance(zm, zero.ZeroShardedModel) and opt2._zero_model is zm
    shards = zm.shard()
    assert zm.cast_params(shards)["wpe"].dtype == torch.float32
    ids = torch.from_numpy(_batch(0)[0]).long()
    out = zm(shards, ids)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, model(ids), rtol=0, atol=0)


def test_unported_knobs_raise():
    with pytest.raises(NotImplementedError, match="A9"):
        zero.ZeroOptimizer(lr=LR, overlap_comm=True)
    with pytest.raises(NotImplementedError, match="A9"):
        zero.ZeroShardedModel(None, overlap_comm=True)
    with pytest.raises(NotImplementedError, match="A14"):
        zero.ZeroOptimizer(lr=LR, autotune="cache")
    with pytest.raises(ValueError, match="compress_allgather"):
        zero.ZeroOptimizer(lr=LR, compress_allgather="fp4")
    with pytest.raises(NotImplementedError):
        zero.make_train_step(lambda m: 0.0, zero.ZeroShardedModel(None),
                             zero.ZeroOptimizer(lr=LR),
                             grad_dtype=torch.bfloat16)


def test_tier2_adam_world1_is_bitwise_the_dense_fused_adam(jparams):
    """``DistributedFusedAdam`` at world 1 through ``amp.make_train_step``
    is the dense FusedAdam O2 step, bit for bit (the same plain ops over
    one flat buffer)."""
    ids, labels = _batch(7)
    t_ids, t_lab = torch.from_numpy(ids), torch.from_numpy(labels)
    runs = []
    for opt in (DistributedFusedAdam(lr=LR, weight_decay=0.01),
                FusedAdam(lr=LR, weight_decay=0.01)):
        model = GPT.params_from_jax(GPTConfig(dtype=torch.bfloat16, **SHAPE),
                                    jparams, device="cpu")
        am, opt = amp.initialize(model, opt, opt_level="O2",
                                 loss_scale="dynamic", verbosity=0)
        am.cast_params()
        state = opt.init(model.parameters())
        step = amp.make_train_step(lambda m, i, l: m.loss(i, l), opt)
        ss = opt._scaler.state
        for _ in range(3):
            _, state, ss, loss = step(model, state, ss, t_ids, t_lab)
        runs.append((model, state, float(loss)))
    (zm, zs, zl), (dm, ds, dl) = runs
    assert zl == dl
    g = ds.groups[0]
    assert torch.equal(zs.master_shard, g.master)
    assert torch.equal(zs.m_shard, g.slots["exp_avg"])
    assert torch.equal(zs.v_shard, g.slots["exp_avg_sq"])
    for a, b in zip(zm.parameters(), dm.parameters()):
        assert torch.equal(a, b)
