"""Attention dropout in the flash backward's two-kernel split, against the
JAX package's split, on the CPU.

JAX is forced onto its split (``_FUSED_BWD_MAX_KV_BYTES`` = 0; nothing in
the JAX package changes) and runs in Pallas interpret mode, as its own CPU
tests run it, with the same seed as the port. The split's plain versions
(``flash_bwd_dq_reference``: dq and the delta it folds in from the dropped
output; ``flash_bwd_dkdv_reference``: dk, dv from that delta) apply the
``_p_dp_ds`` rule (``apex_tpu/ops/flash_attention.py:526-555``) with the
keep mask of ``dropout_keep_reference``, bit for bit JAX's: fp32 within
1e-5 of the largest gradient (fp32 math on both sides, other summation
order); bf16 within two bf16 ulps plus 2 % of the largest (the Pallas
kernels round the dropped p and ds to bf16 before their products, the
plain versions keep fp32). A tiny GPT in training mode (the shape of
``tests/test_torch_gpt_dropout.py``) takes JAX's per-layer seeds through
the split's plain versions on the port's side and JAX's forced split on
the other: loss within 1e-5, gradients within 1e-4 of the largest value.
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.models import gpt as jgpt_mod
from apex_tpu.ops.lm_head_ce import fused_lm_head_cross_entropy
from apex_tpu.transformer import parallel_state as ps
from apex_tpu_torch.models import gpt as tgpt_mod
from apex_tpu_torch.models.gpt import GPT, GPTConfig
from apex_tpu_torch.ops import flash_attention as tfa

# ``apex_tpu.ops`` re-exports a function of the same name as the module
jfa = importlib.import_module("apex_tpu.ops.flash_attention")

RATE, SEED = 0.1, -20261018


def _force_jax_split(monkeypatch):
    """JAX's backward on its split, and a record that its dk/dv and dq
    kernels ran."""
    monkeypatch.setattr(jfa, "_FUSED_BWD_MAX_KV_BYTES", 0)
    ran = []
    for name in ("_dkdv_kernel", "_dq_kernel"):
        kernel = getattr(jfa, name)

        def spy(*refs, _kernel=kernel, _name=name, **kw):
            ran.append(_name)
            return _kernel(*refs, **kw)

        monkeypatch.setattr(jfa, name, spy)
    return ran


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("features", ["causal", "full", "segments"])
def test_plain_split_with_dropout_matches_jax_split(features, dtype,
                                                    monkeypatch):
    """s256 d64: dq and delta, then dk and dv on that delta, with dropout
    0.1, against JAX's split in interpret mode with the same seed."""
    rng = np.random.RandomState(18)
    b, h, s, d = 1, 2, 256, 64
    q, k, v, do = (rng.randn(b, h, s, d).astype(np.float32)
                   for _ in range(4))
    kw, tkw = {}, {}
    if features != "full":
        kw["causal"] = tkw["causal"] = True
    if features == "segments":
        sid = (rng.randint(0, 3, (b, s)).cumsum(-1) // 2).astype(np.int32)
        sid[:, -24:] = -1                                   # padding rows
        kw.update(segment_ids_q=jnp.asarray(sid))
        tkw.update(segment_ids_q=torch.from_numpy(sid))
    ran = _force_jax_split(monkeypatch)
    if dtype == "bfloat16":
        jarr = [jnp.asarray(a.astype(ml_dtypes.bfloat16)) for a in
                (q, k, v, do)]
        tarr = [torch.from_numpy(a).to(torch.bfloat16) for a in
                (q, k, v, do)]
    else:
        jarr = [jnp.asarray(a) for a in (q, k, v, do)]
        tarr = [torch.from_numpy(a) for a in (q, k, v, do)]

    def jf(qq, kk, vv):
        return jfa.flash_attention(qq, kk, vv, block_q=128, block_k=128,
                                   block_q_bwd=128, block_k_bwd=128,
                                   dropout_rate=RATE, dropout_seed=SEED,
                                   interpret=True, autotune="off", **kw)

    _, vjp = jax.vjp(jf, *jarr[:3])
    jgrads = vjp(jarr[3])
    assert set(ran) == {"_dkdv_kernel", "_dq_kernel"}
    drop = dict(dropout_rate=RATE, dropout_seed=SEED)
    tq, tk, tv, tdo = tarr
    out, lse = tfa.flash_attention_reference(tq, tk, tv, **tkw, **drop)
    dq, delta = tfa.flash_bwd_dq_reference(tq, tk, tv, out, lse, tdo,
                                           **tkw, **drop)
    dk, dv = tfa.flash_bwd_dkdv_reference(tq, tk, tv, lse, delta, tdo,
                                          **tkw, **drop)
    want = (tdo.float() * out.float()).sum(-1)
    assert delta.dtype == torch.float32 and delta.shape == (b, h, s)
    np.testing.assert_allclose(delta.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    for got, ref in zip((dq, dk, dv), jgrads):
        assert got.dtype == tq.dtype
        g = got.float().numpy()
        r = np.asarray(ref, np.float32)
        scale = float(np.abs(r).max())
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=1e-5 * scale, rtol=0)
        else:
            tol = np.abs(r) * 2 * 2.0 ** -7 + 2e-2 * scale
            assert np.all(np.abs(g - r) <= tol), float(np.abs(g - r).max())
    # the dropout moved every gradient: not the split without it
    dq0, delta0 = tfa.flash_bwd_dq_reference(
        tq, tk, tv, tfa.flash_attention_reference(tq, tk, tv, **tkw)[0],
        lse, tdo, **tkw)
    dk0, dv0 = tfa.flash_bwd_dkdv_reference(tq, tk, tv, lse, delta0, tdo,
                                            **tkw)
    for got, plain in zip((dq, dk, dv), (dq0, dk0, dv0)):
        assert not torch.allclose(got.float(), plain.float())


@pytest.mark.parametrize("causal,seg", [(True, False), (False, True)])
def test_split_references_compose_to_the_plain_dropout_backward(causal,
                                                                seg):
    """dq with its folded delta, then dk/dv on that delta, is the plain
    backward with the same dropout (the same operations; bitwise on the
    CPU), and rate 0 is the split without dropout, bitwise."""
    g = torch.Generator().manual_seed(4)
    b, h, s, d = 2, 2, 48, 16
    q, k, v, do = (torch.randn(b, h, s, d, generator=g) for _ in range(4))
    sid = None
    if seg:
        sid = torch.zeros(b, s, dtype=torch.int32)
        sid[:, 20:] = 1
        sid[1, 40:] = -1
    kw = dict(causal=causal, segment_ids_q=sid)
    drop = dict(dropout_rate=0.3, dropout_seed=77)
    out, lse = tfa.flash_attention_reference(q, k, v, **kw, **drop)
    dq, delta = tfa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw,
                                           **drop)
    dk, dv = tfa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do, **kw,
                                          **drop)
    ref = tfa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw,
                                            **drop)
    for got, r in zip((dq, dk, dv), ref):
        assert torch.equal(got, r)
    for kwargs in (dict(dropout_rate=0.0, dropout_seed=77), {}):
        a = tfa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw,
                                       **kwargs)
        b_ = tfa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b_))
        a = tfa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do, **kw,
                                         **kwargs)
        b_ = tfa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b_))


SHAPE = dict(vocab_size=64, max_seq_len=32, hidden_size=32, num_layers=2,
             num_heads=2)
B, S = 2, 32


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(val, np.float32)
    return out


def test_training_gpt_through_the_split_matches_jax(monkeypatch):
    """The tiny GPT in training mode (attention dropout 0.2) with JAX's
    backward forced onto its split and the port's through the split's
    plain versions (dq with the delta fold, then dk/dv), JAX's per-layer
    seeds replayed into the port's attention calls: loss 1e-5, every
    gradient 1e-4 of its largest value."""
    ps.destroy_model_parallel()
    jparams = jax.device_get(jgpt_mod.GPT(jgpt_mod.GPTConfig(
        dtype=jnp.float32, **SHAPE)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    ids = np.random.RandomState(3).randint(0, SHAPE["vocab_size"],
                                           (B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    gpt = jgpt_mod.GPT(jgpt_mod.GPTConfig(dtype=jnp.float32,
                                          attention_dropout=0.2, **SHAPE))
    key = jax.random.PRNGKey(7)

    def jloss(p):
        hidden = gpt.apply({"params": p}, jnp.asarray(ids),
                           deterministic=False, return_hidden=True,
                           rngs={"dropout": key})
        return jnp.mean(fused_lm_head_cross_entropy(
            hidden, p["wte"]["embedding"], jnp.asarray(labels),
            axis_name=ps.TENSOR_AXIS))

    seeds, jflash = [], jgpt_mod.flash_attention

    def record(*a, **kw):
        seeds.append(int(jax.device_get(kw["dropout_seed"])))
        return jflash(*a, **kw)

    monkeypatch.setattr(jgpt_mod, "flash_attention", record)
    jloss(jax.tree.map(jnp.asarray, jparams))
    monkeypatch.setattr(jgpt_mod, "flash_attention", jflash)
    assert len(seeds) == SHAPE["num_layers"]
    ran = _force_jax_split(monkeypatch)
    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jparams))
    assert set(ran) == {"_dkdv_kernel", "_dq_kernel"}

    # the port: JAX's seeds in order, the backward through the split's
    # plain versions
    feed, tflash = list(seeds), tgpt_mod.flash_attention

    def replay(*a, dropout_rate, dropout_seed, **kw):
        assert dropout_rate == 0.2 and dropout_seed is not None
        return tflash(*a, dropout_rate=dropout_rate,
                      dropout_seed=feed.pop(0), **kw)

    split_calls = []

    def split_bwd(q, k, v, out, lse, do, *, dropout_rate, dropout_seed,
                  **kw):
        split_calls.append(dropout_seed)
        drop = dict(dropout_rate=dropout_rate, dropout_seed=dropout_seed)
        dq, delta = tfa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw,
                                               **drop)
        dk, dv = tfa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do,
                                              **kw, **drop)
        return dq, dk, dv

    monkeypatch.setattr(tgpt_mod, "flash_attention", replay)
    monkeypatch.setattr(tfa, "flash_attention_bwd_reference", split_bwd)
    model = GPT.params_from_jax(
        GPTConfig(dtype=torch.float32, attention_dropout=0.2, **SHAPE),
        jparams, device="cpu")
    loss = model.loss(torch.from_numpy(ids), torch.from_numpy(labels),
                      deterministic=False,
                      generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert not feed and split_calls == list(reversed(seeds))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jflat = _flat(jax.device_get(jg))
    for name, p in model.named_parameters():
        ref = jflat[name]
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 1e-4 * max(float(np.abs(ref).max()), 1e-30), name
