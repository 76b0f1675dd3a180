"""The port's GPT in training mode (Megatron's attention and hidden
dropout) against the JAX package's, on the CPU (2 layers, h32, 2 heads,
V64, fp32).

Attention dropout: the JAX model draws a per-layer int32 seed from its
``dropout`` rng and the flash kernel hashes it into the keep mask; the port
draws its seeds from a host ``torch.Generator``. The two streams differ, so
the test records JAX's seeds (a wrapper around
``apex_tpu.models.gpt.flash_attention``) and hands them to the port's
attention calls in the same order (a wrapper around the port's): the masks
are then the same bits and the loss and every gradient match JAX within
1e-5 and 1e-4 of the largest value (fp32 on both sides, other summation
orders). Hidden dropout cannot be compared with flax's bernoulli stream,
so it is held to its own contract: rate 0 the identity, the same generator
state the same bits, a keep share within binomial bounds, kept values
scaled by 1 / (1 - rate). ``deterministic=True`` (the default) is bitwise
the no-dropout configuration, as ``tests/test_models.py::test_gpt_dropout``
holds the JAX model.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.models import gpt as jgpt_mod
from apex_tpu.ops.lm_head_ce import fused_lm_head_cross_entropy
from apex_tpu.transformer import parallel_state as ps
from apex_tpu_torch import amp
from apex_tpu_torch.models import gpt as tgpt_mod
from apex_tpu_torch.models.gpt import GPT, GPTConfig
from apex_tpu_torch.optimizers import FusedAdam

SHAPE = dict(vocab_size=64, max_seq_len=32, hidden_size=32, num_layers=2,
             num_heads=2)
B, S = 2, 32


def _batch(seed=0):
    ids = np.random.RandomState(seed).randint(0, SHAPE["vocab_size"],
                                              (B, S)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def jparams():
    ps.destroy_model_parallel()
    cfg = jgpt_mod.GPTConfig(dtype=jnp.float32, **SHAPE)
    return jax.device_get(jgpt_mod.GPT(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


def test_attention_dropout_loss_and_grads_match_jax(jparams, monkeypatch):
    ids, labels = _batch()
    jcfg = jgpt_mod.GPTConfig(dtype=jnp.float32, attention_dropout=0.2,
                              **SHAPE)
    gpt = jgpt_mod.GPT(jcfg)
    key = jax.random.PRNGKey(5)

    def jloss(p):
        hidden = gpt.apply({"params": p}, jnp.asarray(ids),
                           deterministic=False, return_hidden=True,
                           rngs={"dropout": key})
        return jnp.mean(fused_lm_head_cross_entropy(
            hidden, p["wte"]["embedding"], jnp.asarray(labels),
            axis_name=ps.TENSOR_AXIS))

    # JAX's per-layer seeds, recorded in a forward of the same rng
    seeds, jflash = [], jgpt_mod.flash_attention

    def record(*a, **kw):
        seeds.append(int(jax.device_get(kw["dropout_seed"])))
        return jflash(*a, **kw)

    monkeypatch.setattr(jgpt_mod, "flash_attention", record)
    jloss(jax.tree.map(jnp.asarray, jparams))
    monkeypatch.setattr(jgpt_mod, "flash_attention", jflash)
    assert len(seeds) == SHAPE["num_layers"]
    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jparams))

    # the port's attention calls take those seeds, in order
    feed, tflash = list(seeds), tgpt_mod.flash_attention

    def replay(*a, dropout_rate, dropout_seed, **kw):
        assert dropout_rate == 0.2 and dropout_seed is not None
        return tflash(*a, dropout_rate=dropout_rate,
                      dropout_seed=feed.pop(0), **kw)

    monkeypatch.setattr(tgpt_mod, "flash_attention", replay)
    model = GPT.params_from_jax(
        GPTConfig(dtype=torch.float32, attention_dropout=0.2, **SHAPE),
        jparams, device="cpu")
    loss = model.loss(torch.from_numpy(ids), torch.from_numpy(labels),
                      deterministic=False,
                      generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert not feed
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jflat = _flat(jax.device_get(jg))
    for name, p in model.named_parameters():
        ref = jflat[name]
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 1e-4 * max(float(np.abs(ref).max()), 1e-30), name
    # the recorded seeds changed the loss: not the deterministic one
    monkeypatch.setattr(tgpt_mod, "flash_attention", tflash)
    det = model.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    assert abs(float(det.detach()) - float(loss.detach())) > 1e-4


def _model(attention=0.3, hidden=0.3, dtype=torch.float32):
    cfg = GPTConfig(dtype=dtype, attention_dropout=attention,
                    hidden_dropout=hidden, **SHAPE)
    return GPT.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")


def test_hidden_dropout_contract():
    model = _model(attention=0.0, hidden=0.3)
    rngs = model._dropout_rngs(False, torch.Generator().manual_seed(1))
    y = torch.randn(64, 1000, generator=torch.Generator().manual_seed(2))
    out = model._hdrop(y, rngs)
    kept = out != 0
    n, share = y.numel(), float(kept.float().mean())
    # 0.7 +- 5 binomial standard deviations
    assert abs(share - 0.7) <= 5 * (0.7 * 0.3 / n) ** 0.5
    assert torch.equal(out[kept], y[kept] / (1.0 - 0.3))
    # the same generator state gives the same bits
    again = model._hdrop(y, model._dropout_rngs(
        False, torch.Generator().manual_seed(1)))
    assert torch.equal(out, again)
    # rate 0 is the identity
    zero = _model(attention=0.3, hidden=0.0)
    assert zero._hdrop(y, zero._dropout_rngs(
        False, torch.Generator().manual_seed(1))) is y


def test_deterministic_is_bitwise_the_no_dropout_config():
    model = _model()
    base = GPT(GPTConfig(dtype=torch.float32, **SHAPE), device="cpu")
    base.load_state_dict(model.state_dict())
    ids = torch.from_numpy(_batch(1)[0])
    det = model(ids)
    assert torch.equal(det, base(ids))

    def train(seed):
        return model(ids, deterministic=False,
                     generator=torch.Generator().manual_seed(seed))

    y1, y1b, y2 = train(1), train(1), train(2)
    assert torch.equal(y1, y1b)
    assert not torch.allclose(y1, det)
    assert not torch.allclose(y1, y2)
    # the reference path (plain kernels, autograd) draws the same seeds and
    # masks: on the CPU the two are the same function
    ref = model(ids, reference=True, deterministic=False,
                generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(ref, y1, rtol=1e-6, atol=1e-6)
    loss = model.loss(ids, torch.roll(ids, -1, 1), deterministic=False,
                      generator=torch.Generator().manual_seed(3))
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_training_mode_needs_a_host_generator_and_valid_rates():
    model = _model()
    ids = torch.from_numpy(_batch(1)[0])
    with pytest.raises(ValueError, match="host"):
        model(ids, deterministic=False)
    with pytest.raises(ValueError, match="must be in"):
        GPTConfig(attention_dropout=1.0, **SHAPE)
    with pytest.raises(ValueError, match="must be in"):
        GPTConfig(hidden_dropout=-0.1, **SHAPE)
    # no dropout configured: training mode needs no generator
    assert torch.equal(_model(0.0, 0.0)(ids, deterministic=False),
                       _model(0.0, 0.0)(ids))


def test_o2_dropout_steps_train_and_match_the_plain_twin():
    """The chip's dropout path at a tiny size: three O2 FusedAdam steps
    with Megatron dropout from one host generator (finite losses), and the
    loss and gradients of one step through the kernels' entry points
    against ``reference=True`` with a generator in the same state."""
    ids, labels = map(torch.from_numpy, _batch(2))
    model = _model(0.1, 0.1)
    amp_model, opt = amp.initialize(model, FusedAdam(lr=1e-3),
                                    opt_level="O2", loss_scale="dynamic",
                                    verbosity=0)
    amp_model.cast_params()
    state = opt.init(model.parameters())
    gen = torch.Generator().manual_seed(0)
    step = amp.make_train_step(
        lambda m, i, l: m.loss(i, l, deterministic=False, generator=gen),
        opt)
    sstate, losses = opt._scaler.state, []
    for _ in range(3):
        _, state, sstate, loss = step(model, state, sstate, ids, labels)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    params = list(model.parameters())
    loss = model.loss(ids, labels, deterministic=False,
                      generator=torch.Generator().manual_seed(9))
    grads = torch.autograd.grad(loss, params)
    ref = model.loss(ids, labels, reference=True, deterministic=False,
                     generator=torch.Generator().manual_seed(9))
    rgrads = torch.autograd.grad(ref, params)
    assert abs(float(loss) - float(ref)) <= 1e-3
    for g, r in zip(grads, rgrads):
        rel = float((g.float() - r.float()).norm()
                    / r.float().norm().clamp_min(1e-30))
        assert rel <= 3e-2
