"""Attention dropout wherever the single pass runs, on the CPU: the wgmma
single pass with the bias and dropout together, and the fp32 FFMA route's
forward and single pass with dropout.

The route table: ``dropout_refusal`` and ``_bwd_route`` take fp32 dropout
at kernel head dims 64 and 128 on the FFMA single pass (s1024 d64, the O0
GPT step's shape, stays on it) and, where the backward splits, on the
FFMA split's dropout variants; fp32 over narrower operands (which round p
or ds) stays on the frag.cuh kernels and keeps their refusal; the FFMA
route takes the bias alone and with dropout; bf16 with the
bias and dropout takes the single pass at s128 (the gate counts 512-row
blocks with both) and splits at s512.

The CUDA wrappers, with the library stubbed (no card): the seed, threshold
and 1 / (1 - rate) reach ``apex_flash_fwd_f32`` and ``apex_flash_bwd_f32``
(threshold 0 at rate 0), the bias and the dropout reach the wgmma single
pass together, and only the new counters move (an FFMA launch with dropout
on ``.f32_dropout_launches`` beside ``.f32_launches``; the single pass with
both on ``.bias_dropout_fused_launches``, not on the bias or dropout
counters). A refused case raises before any call: no route falls back to
the plain version.

Against the JAX package: an fp32 GPT (2 layers, h32, 2 heads, V64) in
training with Megatron's attention and hidden dropout 0.2 (the CPU route
runs the plain versions): JAX's per-layer attention seeds and its hidden
dropout masks are recorded and replayed into the port, whose loss then
agrees within 1e-5 relative and every gradient within 1e-4 of the largest
value (fp32 on both sides, sums in other orders). ``SelfMultiheadAttn(
use_bias=True, include_norm_add=True, impl="fast", dropout=0.1)`` under
fairseq's future mask and key padding at a shape both packages keep on
the single pass (JAX's ``_bwd_fused_kernel`` ran, in interpret mode): its
attention seed and output-dropout mask replayed, the output, the input's
and every parameter's gradient within 1e-5 of the largest value.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import stochastic

from apex_tpu.contrib import multihead_attn as jmha
from apex_tpu.contrib.multihead_attn import self_multihead_attn as jself_mod
from apex_tpu.models import gpt as jgpt_mod
from apex_tpu.ops.lm_head_ce import fused_lm_head_cross_entropy
from apex_tpu.transformer import parallel_state as ps
from apex_tpu_torch.contrib import multihead_attn as tmha
from apex_tpu_torch.contrib.multihead_attn import self_multihead_attn as \
    tself_mod
from apex_tpu_torch.models import gpt as tgpt_mod
from apex_tpu_torch.models.gpt import GPT, GPTConfig
from apex_tpu_torch.ops import flash_attention as tfa

# ``apex_tpu.ops`` re-exports a function of the same name as the module
jfa = importlib.import_module("apex_tpu.ops.flash_attention")

F32, BF = torch.float32, torch.bfloat16


# ---------------------------------------------------------------------------
# the route table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kd,s,split", [(64, 64, False), (128, 64, False),
                                        (64, 1024, False), (64, 4096, True),
                                        (128, 4096, True)])
def test_fp32_dropout_takes_the_ffma_single_pass_and_refuses_its_split(
        kd, s, split):
    """fp32 dropout at kernel head dims 64 and 128: the FFMA single pass
    takes it (s1024 d64, the O0 step, included), and where the gate splits
    the FFMA split's dropout variants take it (its refusal is lifted); the
    forward takes it at any length."""
    assert tfa.uses_split_backward(s, s, kd, 4, 4, True,
                                   dropout=True) == split
    q = torch.zeros(1, 1, s, kd)
    assert tfa.dropout_refusal(F32, kd) is None
    assert tfa._bwd_route(q, q, q, True, 0.1) == (split, F32)
    assert tfa._bwd_route(q, q, q, True, 0.0) == (split, F32)


@pytest.mark.parametrize("dtypes", [(BF, F32, BF), (BF, BF, F32),
                                    (F32, BF, F32)])
def test_mixed_operands_keep_the_frag_route_refusal(dtypes):
    """Operands promoted to fp32 whose kernels round p or ds to a narrower
    dtype stay on the frag.cuh kernels, which take no dropout: the
    backward's route names them, whatever ``do`` is."""
    q, k, v = (torch.zeros(1, 2, 64, 64, dtype=dt) for dt in dtypes)
    assert tfa.dropout_refusal(F32, 64, ffma=False) is not None
    for do in (None, q, k):
        with pytest.raises(NotImplementedError, match="frag.cuh"):
            tfa._bwd_route(q, k, v, True, 0.1, do)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_the_ffma_route_still_refuses_the_bias(dropout):
    """The fp32 FFMA route takes the bias alone (its bias variants) and
    with dropout (its variants with both), on the single pass at s128;
    over narrower operands (p or ds rounded) frag.cuh still refuses it,
    with dropout or without."""
    assert tfa.bias_refusal(F32, 64) is None
    assert "frag.cuh" in tfa.bias_refusal(F32, 64, ffma=False)
    q = torch.zeros(1, 2, 128, 64)
    assert tfa._bwd_route(q, q, q, True, dropout, bias=True) == (False, F32)
    k = q.to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="bias.*frag.cuh"):
        tfa._bwd_route(q, k, k, True, dropout, bias=True)


@pytest.mark.parametrize("s,d,split", [(128, 64, False), (448, 64, False),
                                       (384, 128, False), (512, 64, True),
                                       (448, 128, True)])
def test_bf16_bias_with_dropout_takes_the_single_pass_under_the_gate(s, d,
                                                                     split):
    """bf16 with the bias and dropout: the single pass takes both where
    the gate keeps it (s128, the wmt path's sentences; s448 at d 64, s384
    at d 128), the split past it; neither raises."""
    q = torch.zeros(2, 2, s, d, dtype=BF)
    assert tfa.uses_split_backward(s, s, d, bias=True, dropout=True) == split
    assert tfa._bwd_route(q, q, q, False, 0.1, bias=True) == (split, BF)
    assert tfa.bias_refusal(BF, d) is None
    assert tfa.dropout_refusal(BF, d) is None


# ---------------------------------------------------------------------------
# the CUDA wrappers' C calls (the library stubbed: no card)
# ---------------------------------------------------------------------------

def _stub_library(monkeypatch):
    """The C calls the wrappers make, recorded instead of run (CPU tensors
    stand for the card's): ``(target, symbol, args)``; the device check
    answers CUDA. The flash launch counters get their values back at the
    test's end."""
    for fn in (tfa.flash_attention, tfa.flash_attention_bwd):
        for name, value in list(vars(fn).items()):
            if name.endswith("launches"):
                monkeypatch.setattr(fn, name, value)
    calls = []

    def function(target, symbol, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes), symbol
            calls.append((target, symbol, args))
            return 0
        return fn

    monkeypatch.setattr(tfa._build, "function", function)
    monkeypatch.setattr(tfa, "_stream", lambda t: None)
    monkeypatch.setattr(tfa, "check_device_type", lambda t, what: "cuda")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {
                            "multi_processor_count": 132})())
    return calls


def _counts():
    f, g = tfa.flash_attention, tfa.flash_attention_bwd
    return dict(fwd_f32=f.f32_launches, fwd_f32_drop=f.f32_dropout_launches,
                bwd_f32=g.f32_launches, bwd_f32_drop=g.f32_dropout_launches,
                fwd_drop=f.dropout_launches, bwd_drop=g.dropout_launches,
                fwd_both=f.bias_dropout_launches, fwd_bias=f.bias_launches,
                single=g.launches, single_bias=g.bias_launches,
                single_both=g.bias_dropout_fused_launches,
                dkdv_both=g.bias_dropout_dkdv_launches,
                dq_both=g.bias_dropout_dq_launches)


def _moved(n0):
    return {k: v - n0[k] for k, v in _counts().items() if v != n0[k]}


@pytest.mark.parametrize("d,s", [(64, 1024), (128, 512)])
def test_ffma_wrappers_pass_the_dropout(monkeypatch, d, s):
    """fp32 through ``flash_attention`` at s1024 d64 and s512 d128 (the
    single pass; the gate splits fp32 with dropout from s513 at d 128): the
    forward's and the single pass's FFMA entries each get the seed,
    threshold and 1 / (1 - rate) before the stream, and the FFMA dropout
    counters move beside the FFMA route's; at rate 0 they get (0, 0, 1.0)
    and the dropout counters stay."""
    calls = _stub_library(monkeypatch)
    q = torch.zeros(2, 3, s, d, requires_grad=True)
    n0 = _counts()
    out = tfa.flash_attention(q, q, q, causal=True, dropout_rate=0.1,
                              dropout_seed=-9)
    out.sum().backward()
    assert [c[1] for c in calls] == ["apex_flash_fwd_f32",
                                     "apex_flash_bwd_f32"]
    drop = tfa._dropout_args(0.1, -9)
    assert drop[1] > 0
    for target, symbol, args in calls:
        assert target == "flash_fwd@f32" if "fwd" in symbol else \
            target == "flash_bwd@f32"
        assert args[-4:-1] == drop and args[-1] is None, symbol
    assert _moved(n0) == dict(fwd_f32=1, fwd_f32_drop=1, bwd_f32=1,
                              bwd_f32_drop=1, single=1)
    calls.clear()
    n0 = _counts()
    q.grad = None
    tfa.flash_attention(q, q, q, causal=True).sum().backward()
    assert [c[2][-4:-1] for c in calls] == [(0, 0, 1.0)] * 2
    assert _moved(n0) == dict(fwd_f32=1, bwd_f32=1, single=1)


def test_ffma_forward_takes_dropout_where_the_split_refuses(monkeypatch):
    """At s4096 fp32 the backward splits, and the split no longer refuses
    dropout: a call that wants gradients runs the FFMA forward and the
    split's dk/dv then dq, each handed the seed, threshold and 1 / (1 -
    rate) before the stream; without gradients the forward alone; the
    split's wrappers called alone take it too."""
    calls = _stub_library(monkeypatch)
    q = torch.zeros(1, 2, 4096, 64, requires_grad=True)
    kw = dict(causal=True, dropout_rate=0.1, dropout_seed=5)
    drop = tfa._dropout_args(0.1, 5)
    tfa.flash_attention(q, q, q, **kw).sum().backward()
    assert [c[1] for c in calls] == ["apex_flash_fwd_f32",
                                     "apex_flash_bwd_f32_dkdv",
                                     "apex_flash_bwd_f32_dq"]
    assert all(c[2][-4:-1] == drop for c in calls)
    calls.clear()
    n0 = _counts()
    with torch.no_grad():
        tfa.flash_attention(q, q, q, **kw)
    assert [c[1] for c in calls] == ["apex_flash_fwd_f32"]
    assert calls[0][2][-4:-1] == drop
    assert _moved(n0) == dict(fwd_f32=1, fwd_f32_drop=1)
    calls.clear()
    qs, lse = q.detach(), torch.zeros(1, 2, 4096)
    args = (qs, qs, qs, qs, lse, lse, None, None, True, 0.125,
            tfa._NO_ROUNDS)
    for split_kernel in (tfa._flash_dkdv_cuda, tfa._flash_dq_cuda):
        split_kernel(*args, dropout=drop)
    assert [c[1] for c in calls] == ["apex_flash_bwd_f32_dkdv",
                                     "apex_flash_bwd_f32_dq"]
    assert all(c[2][-4:-1] == drop for c in calls)


def test_wgmma_single_pass_takes_the_bias_and_the_dropout(monkeypatch):
    """The wmt path's attention (b28 h16 s128 d64 bf16, a [1, 1, 128, 128]
    future mask, key padding as segment ids, dropout 0.1) through
    ``flash_attention``: the forward's and the single pass's variants with
    both, each handed the bias pointer and strides and the dropout; only
    the counters with both move."""
    calls = _stub_library(monkeypatch)
    b, h, s, d = 28, 16, 128, 64
    q = torch.zeros(b, h, s, d, dtype=BF, requires_grad=True)
    bias = torch.triu(torch.full((s, s), float("-inf")), 1)[None, None]
    lens = torch.from_numpy(np.random.RandomState(6).randint(96, 129, b))
    sid_kv = torch.where(torch.arange(s)[None] < lens[:, None], 0, -1)
    sid_q = torch.zeros(b, s, dtype=torch.int32)
    n0 = _counts()
    out = tfa.flash_attention(q, q, q, sid_q, sid_kv.to(torch.int32),
                              bias=bias, dropout_rate=0.1, dropout_seed=11)
    out.float().sum().backward()
    assert [c[1] for c in calls] == ["apex_flash_fwd_sm90",
                                     "apex_flash_bwd_sm90_fused"]
    drop = tfa._dropout_args(0.1, 11)
    for _, symbol, args in calls:
        ptr, sb, sh = args[-7:-4]
        assert ptr.value is not None and (sb, sh) == (0, 0), symbol
        assert args[-4:-1] == drop, symbol
    assert _moved(n0) == dict(fwd_both=1, single=1, single_both=1)


# ---------------------------------------------------------------------------
# an fp32 GPT with attention and hidden dropout against the JAX package
# ---------------------------------------------------------------------------

SHAPE = dict(vocab_size=64, max_seq_len=32, hidden_size=32, num_layers=2,
             num_heads=2)
GB, GS, RATE = 2, 32, 0.2


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def test_fp32_gpt_with_attention_and_hidden_dropout_matches_jax(monkeypatch):
    """The O0 configuration in miniature: JAX's attention seeds (a wrapper
    around its GPT's ``flash_attention``) and hidden dropout masks (flax's
    ``bernoulli``), recorded in a forward of the same rng, replayed into
    the port's attention calls and ``GPT._hdrop`` in order: loss within
    1e-5 relative, every gradient within 1e-4 of its largest value."""
    ps.destroy_model_parallel()
    ids = np.random.RandomState(3).randint(0, SHAPE["vocab_size"],
                                           (GB, GS)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    jcfg = jgpt_mod.GPTConfig(dtype=jnp.float32, attention_dropout=RATE,
                              hidden_dropout=RATE, **SHAPE)
    gpt = jgpt_mod.GPT(jcfg)
    jparams = jax.device_get(gpt.init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 8), jnp.int32))["params"])
    key = jax.random.PRNGKey(7)

    def jloss(p):
        hidden = gpt.apply({"params": p}, jnp.asarray(ids),
                           deterministic=False, return_hidden=True,
                           rngs={"dropout": key})
        return jnp.mean(fused_lm_head_cross_entropy(
            hidden, p["wte"]["embedding"], jnp.asarray(labels),
            axis_name=ps.TENSOR_AXIS))

    seeds, masks = [], []
    jflash, bernoulli = jgpt_mod.flash_attention, stochastic.random.bernoulli

    def record_seed(*a, **kw):
        seeds.append(int(jax.device_get(kw["dropout_seed"])))
        return jflash(*a, **kw)

    def record_mask(*a, **kw):
        keep = bernoulli(*a, **kw)
        masks.append(np.array(keep))
        return keep

    monkeypatch.setattr(jgpt_mod, "flash_attention", record_seed)
    monkeypatch.setattr(stochastic.random, "bernoulli", record_mask)
    jloss(jax.tree.map(jnp.asarray, jparams))
    monkeypatch.setattr(jgpt_mod, "flash_attention", jflash)
    monkeypatch.setattr(stochastic.random, "bernoulli", bernoulli)
    assert len(seeds) == SHAPE["num_layers"]
    assert len(masks) == 2 * SHAPE["num_layers"]
    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jparams))

    feed_seeds, feed_masks = list(seeds), list(masks)
    tflash = tgpt_mod.flash_attention

    def replay_seed(*a, dropout_rate, dropout_seed, **kw):
        assert dropout_rate == RATE and dropout_seed is not None
        return tflash(*a, dropout_rate=dropout_rate,
                      dropout_seed=feed_seeds.pop(0), **kw)

    def replay_mask(self, y, rngs):
        if rngs is None:            # a deterministic forward
            return y
        keep = torch.from_numpy(feed_masks.pop(0))
        assert keep.shape == y.shape
        return torch.where(keep, y / (1.0 - RATE), torch.zeros_like(y))

    monkeypatch.setattr(tgpt_mod, "flash_attention", replay_seed)
    monkeypatch.setattr(GPT, "_hdrop", replay_mask)
    model = GPT.params_from_jax(
        GPTConfig(dtype=F32, attention_dropout=RATE, hidden_dropout=RATE,
                  **SHAPE), jparams, device="cpu")
    loss = model.loss(torch.from_numpy(ids), torch.from_numpy(labels),
                      deterministic=False,
                      generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert not feed_seeds and not feed_masks
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jflat = _flat(jax.device_get(jg))
    for name, p in model.named_parameters():
        ref = jflat[name]
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 1e-4 * max(float(np.abs(ref).max()), 1e-30), name
    # both dropouts moved the loss: not the deterministic one
    monkeypatch.setattr(tgpt_mod, "flash_attention", tflash)
    det = model.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    assert abs(float(det.detach()) - float(loss.detach())) > 1e-4


# ---------------------------------------------------------------------------
# SelfMultiheadAttn with the mask, key padding and dropout on the single
# pass, against the JAX module
# ---------------------------------------------------------------------------

E, HEADS, S, B = 32, 4, 32, 2


def test_self_multihead_attn_on_the_single_pass_replays_jax(monkeypatch):
    """The fast path at dropout 0.1 with norm_add in training under
    fairseq's future mask [S, S] and key padding, at a shape both packages
    keep on the single pass (JAX's ``_bwd_fused_kernel`` ran, and neither
    split kernel): JAX's attention seed and output-dropout mask recorded
    and replayed into the port's module; the outputs, the input's and
    every parameter's gradient agree within 1e-5 of the largest value."""
    d = E // HEADS
    assert not tfa.uses_split_backward(S, S, d, 4, 4, bias=True,
                                       dropout=True)
    rng = np.random.RandomState(35)
    x = rng.randn(S, B, E).astype(np.float32)
    dout = rng.randn(S, B, E).astype(np.float32)
    mask = np.triu(np.full((S, S), -np.inf, np.float32), 1)
    pad = np.zeros((B, S), bool)
    pad[0, S - 7:] = True
    opts = dict(dropout=0.1, use_bias=True, include_norm_add=True,
                impl="fast")
    jm = jmha.SelfMultiheadAttn(E, HEADS, **opts)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x),
                     is_training=False)["params"]
    seeds, masks, ran = [], [], []
    jflash, bernoulli = jself_mod.flash_attention, stochastic.random.bernoulli

    def record_seed(*a, **kw):
        seeds.append(int(jax.device_get(kw["dropout_seed"])))
        assert kw["bias"] is not None and kw["dropout_rate"] == 0.1
        return jflash(*a, **kw)

    def record_mask(*a, **kw):
        keep = bernoulli(*a, **kw)
        masks.append(np.array(keep))
        return keep

    for name in ("_bwd_fused_kernel", "_dkdv_kernel", "_dq_kernel"):
        kernel = getattr(jfa, name)

        def spy(*refs, _kernel=kernel, _name=name, **kw):
            ran.append(_name)
            return _kernel(*refs, **kw)

        monkeypatch.setattr(jfa, name, spy)
    monkeypatch.setattr(jself_mod, "flash_attention", record_seed)
    monkeypatch.setattr(stochastic.random, "bernoulli", record_mask)

    def jf(p, xx):
        return jm.apply({"params": p}, xx, key_padding_mask=jnp.asarray(pad),
                        attn_mask=jnp.asarray(mask), is_training=True,
                        rngs={"dropout": jax.random.PRNGKey(10)})

    jout, vjp = jax.vjp(jf, params, jnp.asarray(x))
    jgrads = vjp(jnp.asarray(dout))
    monkeypatch.setattr(stochastic.random, "bernoulli", bernoulli)
    assert len(seeds) == 1 and len(masks) == 1
    assert set(ran) == {"_bwd_fused_kernel"}

    prep, rates = tself_mod.prep_fast_path, []

    def replay_seed(*a, **kw):
        sid_q, sid_kv, bias, rate, seed = prep(*a, **kw)
        rates.append((rate, bias is not None))
        return sid_q, sid_kv, bias, rate, seeds[0]

    def replay_mask(t, rate, gen):
        keep = torch.from_numpy(masks[0])
        return torch.where(keep, t / (1.0 - rate), torch.zeros_like(t))

    monkeypatch.setattr(tself_mod, "prep_fast_path", replay_seed)
    monkeypatch.setattr(tself_mod, "dropout", replay_mask)
    tm = tmha.SelfMultiheadAttn.params_from_jax(
        E, HEADS, {n: np.asarray(a) for n, a in
                   jax.device_get(params).items()}, device="cpu", **opts)
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx, key_padding_mask=torch.from_numpy(pad),
             attn_mask=torch.from_numpy(mask),
             generator=torch.Generator().manual_seed(0))
    out.backward(torch.from_numpy(dout))
    assert rates == [(0.1, True)]

    def close(got, ref, what):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.detach().numpy(), ref,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   rtol=0, err_msg=what)

    close(out, jout, "out")
    close(tx.grad, jgrads[1], "input")
    for name, p in tm.named_parameters():
        close(p.grad, jgrads[0][name], name)
    det = tm(tx.detach(), key_padding_mask=torch.from_numpy(pad),
             attn_mask=torch.from_numpy(mask), is_training=False)
    assert not torch.allclose(out.detach(), det, atol=1e-3)
