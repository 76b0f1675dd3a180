"""The port's training slice against the JAX package on a tiny GPT
(2 layers, h64, 4 heads, V256, b2 s32).

The model is initialised by flax and carried across with
``GPT.params_from_jax``; token ids are made with numpy from a seed. The JAX
side runs as its own CPU tests run it (Pallas interpret mode for flash
attention and the fused LM-head loss), the port through its kernels' plain
versions on CPU tensors.

Tolerances and their reasons:

- fp32 loss and gradients: within 1e-5 of the largest value (fp32 on both
  sides, summed in other orders);
- O2 bf16, three ``FusedAdam`` steps with a dynamic loss scale: the losses
  within 2e-2 (bf16 activations rounded at the same points, products
  accumulated in other orders); the fp32 masters within 2 * lr per step
  plus an fp32 ulp of 1 — Adam's first steps move a parameter by about lr
  whatever the size of its gradient, so a near-zero gradient whose sign
  differs between the two sides moves the two masters 2 * lr apart (the
  key third of the qkv bias has a gradient that is zero up to rounding,
  since attention is invariant to it: a quarter of those elements flip) —
  and, over all parameters, at most 2 % of the elements more than lr / 2
  apart; the scaler state exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu.models.gpt import GPT as JGPT
from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu.transformer import parallel_state as ps
from apex_tpu_torch import amp
from apex_tpu_torch.models.gpt import GPT, GPTConfig
from apex_tpu_torch.ops import flash_attention as tfa
from apex_tpu_torch.ops import layer_norm as tln
from apex_tpu_torch.ops import lm_head_ce as tce
from apex_tpu_torch.optimizers import FusedAdam

SHAPE = dict(vocab_size=256, max_seq_len=32, hidden_size=64, num_layers=2,
             num_heads=4)
B, S = 2, 32
LR = 1e-3


def _batch(seed=0):
    ids = np.random.RandomState(seed).randint(0, SHAPE["vocab_size"],
                                              (B, S)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


@pytest.fixture(scope="module")
def jparams():
    ps.destroy_model_parallel()
    cfg = JGPTConfig(dtype=jnp.float32, **SHAPE)
    return jax.device_get(JGPT(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _assert_close_max(got, ref, rel, what):
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


@pytest.mark.parametrize("fused", [True, False])
def test_fp32_loss_and_grads_match_jax(jparams, fused):
    ids, labels = _batch()
    jcfg = JGPTConfig(dtype=jnp.float32, fused_lm_head=fused, **SHAPE)
    gpt = JGPT(jcfg)

    def jloss(p):
        return gpt.loss({"params": p}, jnp.asarray(ids), jnp.asarray(labels))

    jl, jg = jax.value_and_grad(jloss)(jparams)
    model = GPT.params_from_jax(
        GPTConfig(dtype=torch.float32, fused_lm_head=fused, **SHAPE),
        jparams, device="cpu")
    counts = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches,
              tln.layer_norm_bwd.launches, tce.lm_head_ce_bwd.launches)
    loss = model.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    assert counts == (tfa.flash_attention.launches,
                      tfa.flash_attention_bwd.launches,
                      tln.layer_norm_bwd.launches,
                      tce.lm_head_ce_bwd.launches)   # CPU: no kernel
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    jflat = _flat(jax.device_get(jg))
    for name, p in model.named_parameters():
        _assert_close_max(p.grad.numpy(), jflat[name], 1e-5, name)


def test_reference_forward_matches_the_kernel_path_on_cpu(jparams):
    """``reference=True`` (plain forwards, autograd backward) against the
    default path (plain forwards, the explicit plain backwards)."""
    ids, labels = _batch(1)
    model = GPT.params_from_jax(GPTConfig(dtype=torch.float32, **SHAPE),
                                jparams, device="cpu")
    t_ids, t_lab = torch.from_numpy(ids), torch.from_numpy(labels)
    loss = model.loss(t_ids, t_lab)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    ref = model.loss(t_ids, t_lab, reference=True)
    rgrads = torch.autograd.grad(ref, list(model.parameters()))
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-6)
    for (name, _), g, r in zip(model.named_parameters(), grads, rgrads):
        _assert_close_max(g.numpy(), r.numpy(), 1e-5, name)


def _jax_o2_run(jparams, ids, labels, steps):
    gpt = JGPT(JGPTConfig(dtype=jnp.bfloat16, **SHAPE))
    model, opt = jamp.initialize(gpt, JFusedAdam(lr=LR), opt_level="O2",
                                 loss_scale="dynamic", verbosity=0)
    params = model.cast_params(jax.tree.map(jnp.asarray, jparams))
    state = opt.init(params)
    scaler = opt._amp_stash.loss_scalers[0]
    step = jamp.make_train_step(
        lambda p, i, l: gpt.loss({"params": p}, i, l), opt, scaler=scaler,
        donate=False)
    sstate, losses = scaler.state, []
    for _ in range(steps):
        params, state, sstate, loss = step(params, state, sstate,
                                           jnp.asarray(ids),
                                           jnp.asarray(labels))
        losses.append(float(loss))
    return losses, _flat(jax.device_get(state.groups[0].master)), sstate


def _port_o2_run(jparams, ids, labels, steps, lr=LR):
    model = GPT.params_from_jax(GPTConfig(dtype=torch.bfloat16, **SHAPE),
                                jparams, device="cpu")
    amp_model, opt = amp.initialize(model, FusedAdam(lr=lr), opt_level="O2",
                                    loss_scale="dynamic", verbosity=0)
    amp_model.cast_params()
    state = opt.init(model.parameters())
    step = amp.make_train_step(lambda m, i, l: m.loss(i, l), opt)
    sstate, losses = opt._scaler.state, []
    for _ in range(steps):
        _, state, sstate, loss = step(model, state, sstate,
                                      torch.from_numpy(ids),
                                      torch.from_numpy(labels))
        losses.append(float(loss))
    masters = dict(zip([n for n, _ in model.named_parameters()],
                       opt.master_params(state)))
    return model, losses, masters, sstate


def test_o2_bf16_adam_steps_match_jax(jparams):
    ids, labels = _batch(2)
    steps = 3
    jl, jmaster, jss = _jax_o2_run(jparams, ids, labels, steps)
    model, tl, tmaster, tss = _port_o2_run(jparams, ids, labels, steps)
    # O2 casts every parameter, LayerNorm included, to bf16
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=0)
    far, total = 0, 0
    for name, m in tmaster.items():
        assert m.dtype == torch.float32
        diff = np.abs(m.numpy() - jmaster[name])
        assert float(diff.max()) <= 2 * LR * steps + 2.0 ** -23, name
        far += int((diff > LR / 2).sum())
        total += diff.size
        # the model's bf16 params are the masters cast down
        p = dict(model.named_parameters())[name]
        assert torch.equal(p, m.to(torch.bfloat16))
    assert far <= 0.02 * total, far / total
    assert float(tss.loss_scale) == float(jss.loss_scale) == 2.0 ** 16
    assert int(tss.unskipped) == int(jss.unskipped) == steps
    assert bool(tss.overflow) is False


def test_o2_loss_decreases_over_30_steps(jparams):
    ids, labels = _batch(3)
    _, losses, _, _ = _port_o2_run(jparams, ids, labels, 30, lr=3e-3)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.5


def test_overflow_step_skips_bitwise_and_halves_the_scale(jparams):
    ids, labels = _batch(4)
    model = GPT.params_from_jax(GPTConfig(dtype=torch.bfloat16, **SHAPE),
                                jparams, device="cpu")
    amp_model, opt = amp.initialize(model, FusedAdam(lr=LR), opt_level="O2",
                                    loss_scale="dynamic", verbosity=0)
    amp_model.cast_params()
    state = opt.init(model.parameters())
    step = amp.make_train_step(lambda m, i, l: m.loss(i, l), opt)
    t_ids, t_lab = torch.from_numpy(ids), torch.from_numpy(labels)
    _, state, sstate, _ = step(model, state, opt._scaler.state, t_ids, t_lab)
    before_p = [p.detach().clone() for p in model.parameters()]
    before_g = state.groups[0]
    # overflow factory (as tests/test_amp.py builds one): the loss times
    # 1e38, so loss * scale and the gradient seed overflow fp32 and every
    # gradient is inf or nan
    big = amp.make_train_step(lambda m, i, l: m.loss(i, l) * 1e38, opt)
    _, state2, sstate2, loss = big(model, state, sstate, t_ids, t_lab)
    assert not np.isfinite(float(loss) * float(sstate.loss_scale))
    g2 = state2.groups[0]
    assert torch.equal(g2.master, before_g.master)
    for k in before_g.slots:
        assert torch.equal(g2.slots[k], before_g.slots[k])
    assert int(g2.step) == int(before_g.step) == 1
    for p, b in zip(model.parameters(), before_p):
        assert torch.equal(p, b)
    assert float(sstate2.loss_scale) == float(sstate.loss_scale) / 2
    assert bool(sstate2.overflow) and int(sstate2.unskipped) == 0
