"""The fp32 FFMA route's dropout in its split and its additive bias
(forward, single pass, split), on the CPU.

The route table after the lift: ``dropout_refusal`` and ``bias_refusal``
take fp32 at kernel head dims 64 and 128 on the FFMA route, split or not,
and the FFMA route takes the two together (its variants with both); fp32
over narrower operands stays on the frag.cuh kernels and their refusals,
the pair included. The gate's first split lengths, which the documents
quote, are pinned here.

The CUDA wrappers, with the library stubbed (no card): each of the four
FFMA C entries (``apex_flash_fwd_f32``, ``apex_flash_bwd_f32``,
``apex_flash_bwd_f32_dkdv``, ``apex_flash_bwd_f32_dq``) gets the bias
(pointer, batch stride, head stride) and the dropout (seed, threshold,
1 / (1 - rate)) before the stream, null and zeros where unused; the new
counters move and no other counter does.

Against the JAX package: a 2-layer fp32 stack of ``SelfMultiheadAttn(
use_bias=True, include_norm_add=True, impl="fast")`` under fairseq's
future mask with key padding, JAX's on its single pass and on its forced
split (``_FUSED_BWD_MAX_KV_BYTES`` = 0, a spy recording which kernels ran;
nothing in the JAX package changes), against the port's on the CPU: loss
within 1e-5 relative, every gradient within 1e-4 of its largest value. A
tiny fp32 GPT in training mode with Megatron's attention and hidden
dropout, JAX's backward on its forced split and the port's through the
split's plain versions (dq with the delta fold, then dk/dv), JAX's
attention seeds and hidden masks replayed: the same limits.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import stochastic

from apex_tpu.contrib import multihead_attn as jmha
from apex_tpu.models import gpt as jgpt_mod
from apex_tpu.ops.lm_head_ce import fused_lm_head_cross_entropy
from apex_tpu.transformer import parallel_state as ps
from apex_tpu_torch.contrib import multihead_attn as tmha
from apex_tpu_torch.models import gpt as tgpt_mod
from apex_tpu_torch.models.gpt import GPT, GPTConfig
from apex_tpu_torch.ops import flash_attention as tfa

# ``apex_tpu.ops`` re-exports a function of the same name as the module
jfa = importlib.import_module("apex_tpu.ops.flash_attention")

F32, BF = torch.float32, torch.bfloat16


# ---------------------------------------------------------------------------
# the route table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kd,s,causal,split", [
    (64, 1024, True, False), (64, 4096, True, True), (128, 512, True, False),
    (128, 3072, False, True), (64, 640, False, True)])
def test_the_ffma_route_takes_dropout_and_the_bias_split_or_not(kd, s,
                                                                causal,
                                                                split):
    """fp32 at kernel head dims 64 and 128: dropout alone, the bias
    alone and the two together take the FFMA route whether the gate splits
    or not (each counts as the JAX gate counts it: with both, every shape
    here splits, from s452 at d 64 and s400 at d 128)."""
    q = torch.zeros(1, 1, s, kd)
    assert tfa.dropout_refusal(F32, kd) is None
    assert tfa.bias_refusal(F32, kd) is None
    assert tfa._bwd_route(q, q, q, causal, 0.1) == (split, F32)
    assert tfa._bwd_route(q, q, q, causal, 0.0, bias=True) == (split, F32)
    assert tfa._bwd_route(q, q, q, causal, 0.1, bias=True) == (True, F32)


@pytest.mark.parametrize("dtype,kd,ffma", [
    (F32, 32, True), (F32, 256, True), (F32, 512, True), (F32, 64, False),
    (BF, 32, True)])
def test_frag_routes_keep_their_refusals(dtype, kd, ffma):
    """frag.cuh (fp32 at d 32/256/512, fp32 over narrower operands, bf16
    at d 32) takes neither dropout nor the bias, nor the two together."""
    assert "frag.cuh" in tfa.dropout_refusal(dtype, kd, ffma)
    assert "frag.cuh" in tfa.bias_refusal(dtype, kd, ffma)
    with pytest.raises(NotImplementedError, match="bias.*frag.cuh"):
        tfa._refuse_bias(dtype, kd, ffma)


# (kd, causal, bias, dropout, itemsize) -> the first length the gate splits
# (square sq = sk); fp32's are what the documents quote
FIRST_SPLIT = [
    (64, True, False, True, 4, 1025), (64, False, False, True, 4, 608),
    (128, True, False, True, 4, 513), (128, False, False, True, 4, 513),
    (64, True, True, False, 4, 1025), (64, False, True, False, 4, 608),
    (128, True, True, False, 4, 513), (64, True, False, False, 4, 2049),
    (128, True, False, False, 4, 1025), (64, True, False, False, 2, 2049),
    (64, True, True, True, 2, 467), (128, True, True, True, 2, 425),
    (64, True, True, True, 4, 452), (64, False, True, True, 4, 452),
    (128, True, True, True, 4, 400), (128, False, True, True, 4, 400),
]


@pytest.mark.parametrize("kd,causal,bias,dropout,itemsize,first",
                         FIRST_SPLIT)
def test_the_gate_first_splits_at_the_documented_lengths(kd, causal, bias,
                                                         dropout, itemsize,
                                                         first):
    """The first square length the backward splits at, by head dim, mask,
    bias, dropout and operand size: the figures README, ROADMAP and the
    tests quote (fp32 with dropout or a bias: s1025 causal and s608 not at
    d 64, s513 at d 128; fp32 with both: s452 at d 64, s400 at d 128,
    causal or not; fp32 with neither: s2049 at d 64, s1025 at d 128)."""
    def splits(s):
        return tfa.uses_split_backward(s, s, kd, itemsize, itemsize, causal,
                                       bias, dropout)

    assert splits(first) and not splits(first - 1)
    assert all(not splits(s) for s in range(max(1, first - 600), first))


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
    return calls


def _counts():
    """Every flash launch counter, by wrapper and name."""
    return {f"{fn.__name__}.{name}": value
            for fn in (tfa.flash_attention, tfa.flash_attention_bwd)
            for name, value in vars(fn).items() if name.endswith("launches")}


def _moved(n0):
    return {k: v - n0[k] for k, v in _counts().items() if v != n0[k]}


FWD, BWD = "flash_attention", "flash_attention_bwd"


@pytest.mark.parametrize("variant", ["none", "dropout", "bias",
                                     "bias_dropout"])
@pytest.mark.parametrize("split", [False, True])
def test_ffma_entries_get_the_bias_and_the_dropout(monkeypatch, variant,
                                                   split):
    """fp32 at d 64 through ``flash_attention`` (s2560 splits whatever the
    variant; s512 does not with one variant, s384 with both): the
    forward's entry and the backward's (the
    single pass, or the split's dk/dv then dq) each get (bias, batch
    stride, head stride) and
    (seed, threshold, inv) before the stream: null and zeros where unused,
    1 / (1 - rate) rounded by ctypes; the bias [1, 2, s, s] (a broadcast
    batch: stride 0, head stride s * s). The counters of the variant move
    beside the route's own; no other counter moves."""
    calls = _stub_library(monkeypatch)
    s = 2560 if split else 384 if variant == "bias_dropout" else 512
    q = torch.zeros(2, 2, s, 64, requires_grad=True)
    kw, bias_args, drop = {}, (None, 0, 0), (0, 0, 1.0)
    if "dropout" in variant:
        kw = dict(dropout_rate=0.1, dropout_seed=-77)
        drop = tfa._dropout_args(0.1, -77)
        assert drop[0] == 2 ** 32 - 77 and drop[1] > 0
    if "bias" in variant:
        kw["bias"] = torch.zeros(1, 2, s, s)
        bias_args = (True, 0, s * s)
    n0 = _counts()
    tfa.flash_attention(q, q, q, causal=True, **kw).sum().backward()
    symbols = ["apex_flash_fwd_f32"] + (
        ["apex_flash_bwd_f32_dkdv", "apex_flash_bwd_f32_dq"] if split
        else ["apex_flash_bwd_f32"])
    assert [c[1] for c in calls] == symbols
    for target, symbol, args in calls:
        assert target == ("flash_fwd@f32" if "fwd" in symbol
                          else "flash_bwd@f32"), symbol
        ptr, sb, sh = args[-7:-4]
        assert (ptr is not None) == bool(bias_args[0]), symbol
        assert (sb, sh) == bias_args[1:], symbol
        assert args[-4:-1] == drop and args[-1] is None, symbol
    want = {f"{FWD}.launches": 1, f"{FWD}.f32_launches": 1}
    if split:
        want.update({f"{BWD}.dkdv_launches": 1, f"{BWD}.dq_launches": 1,
                     f"{BWD}.f32_dkdv_launches": 1,
                     f"{BWD}.f32_dq_launches": 1})
    else:
        want.update({f"{BWD}.launches": 1, f"{BWD}.f32_launches": 1})
    if variant != "none":
        want[f"{FWD}.f32_{variant}_launches"] = 1
        if split:
            want[f"{BWD}.f32_{variant}_dkdv_launches"] = 1
            want[f"{BWD}.f32_{variant}_dq_launches"] = 1
        else:
            want[f"{BWD}.f32_{variant}_launches"] = 1
    assert _moved(n0) == want


def test_ffma_split_wrappers_refuse_the_bias_with_dropout(monkeypatch):
    """The FFMA split's wrappers called alone take the bias alone, the
    dropout alone and the two together (the C call gets both), and so
    does the forward; over operands that round p or ds (frag.cuh) the same
    wrappers still refuse the pair before any call, naming frag.cuh."""
    calls = _stub_library(monkeypatch)
    qs, lse = torch.zeros(1, 2, 256, 128), torch.zeros(1, 2, 256)
    bias = torch.zeros(1, 1, 256, 256)
    bop = tfa._bias_operand(bias, 1, 2, 256, 256, qs.device, 0.125)
    drop = tfa._dropout_args(0.1, 9)
    args = (qs, qs, qs, qs, lse, lse, None, None, False, 0.125,
            tfa._NO_ROUNDS)
    for wrapper in (tfa._flash_dkdv_cuda, tfa._flash_dq_cuda):
        wrapper(*args, bias=bop)
        wrapper(*args, dropout=drop)
        wrapper(*args, dropout=drop, bias=bop)
        with pytest.raises(NotImplementedError, match="frag.cuh"):
            wrapper(*args[:-1], 0x22, dropout=drop, bias=bop)
    assert [c[1] for c in calls] == ["apex_flash_bwd_f32_dkdv"] * 3 + [
        "apex_flash_bwd_f32_dq"] * 3
    both = [c[2] for c in calls[2::3]]
    assert all(a[-7] is not None and a[-4:-1] == drop for a in both)
    calls.clear()
    tfa._flash_fwd_cuda(qs, qs, qs, None, None, False, 0.125,
                        dropout_rate=0.1, dropout_seed=9, bias=bias)
    assert [c[1] for c in calls] == ["apex_flash_fwd_f32"]
    assert calls[0][2][-7] is not None and calls[0][2][-4:-1] == drop


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _spy_jax_kernels(monkeypatch, split):
    """JAX's backward on its split (``split``) or single pass, and a record
    of the backward kernels that ran."""
    if split:
        monkeypatch.setattr(jfa, "_FUSED_BWD_MAX_KV_BYTES", 0)
    ran = []
    for name in ("_bwd_fused_kernel", "_dkdv_kernel", "_dq_kernel"):
        kernel = getattr(jfa, name)

        def spy(*refs, _kernel=kernel, _name=name, **kw):
            ran.append(_name)
            return _kernel(*refs, **kw)

        monkeypatch.setattr(jfa, name, spy)
    return ran


E, HEADS, S, B, LAYERS = 32, 4, 32, 2, 2


@pytest.mark.parametrize("split", [False, True])
def test_fp32_mha_stack_with_the_mask_matches_jax(monkeypatch, split):
    """Two fp32 ``SelfMultiheadAttn(use_bias=True, include_norm_add=True,
    impl="fast")`` layers in sequence under fairseq's future mask [S, S]
    and key padding, an MSE against a target: JAX's on its single pass or
    its forced split (the spy shows which ran), the port's on the CPU with
    the same parameters; loss within 1e-5 relative, the input's and every
    parameter's gradient within 1e-4 of its largest value."""
    rng = np.random.RandomState(23)
    x = rng.randn(S, B, E).astype(np.float32)
    target = rng.randn(S, B, E).astype(np.float32)
    mask = np.triu(np.full((S, S), -np.inf, np.float32), 1)
    pad = np.zeros((B, S), bool)
    pad[1, S - 6:] = True
    opts = dict(use_bias=True, include_norm_add=True, impl="fast")
    jmods = [jmha.SelfMultiheadAttn(E, HEADS, **opts) for _ in range(LAYERS)]
    params = [m.init(jax.random.PRNGKey(30 + i), jnp.asarray(x),
                     is_training=False)["params"]
              for i, m in enumerate(jmods)]
    ran = _spy_jax_kernels(monkeypatch, split)

    def jloss(ps_, xx):
        for m, p in zip(jmods, ps_):
            xx = m.apply({"params": p}, xx, is_training=False,
                         attn_mask=jnp.asarray(mask),
                         key_padding_mask=jnp.asarray(pad))
        return jnp.mean(jnp.square(xx - jnp.asarray(target)))

    jl, (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        params, jnp.asarray(x))
    assert set(ran) == ({"_dkdv_kernel", "_dq_kernel"} if split
                        else {"_bwd_fused_kernel"})
    tmods = [tmha.SelfMultiheadAttn.params_from_jax(
        E, HEADS, {n: np.asarray(a) for n, a in jax.device_get(p).items()},
        device="cpu", **opts) for p in params]
    tx = torch.from_numpy(x).requires_grad_()
    y = tx
    for m in tmods:
        y = m(y, is_training=False, attn_mask=torch.from_numpy(mask),
              key_padding_mask=torch.from_numpy(pad))
    loss = (y - torch.from_numpy(target)).square().mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)

    def close(got, ref, what):
        ref = np.asarray(ref, np.float32)
        err = float(np.abs(got.detach().numpy() - ref).max())
        assert err <= 1e-4 * max(float(np.abs(ref).max()), 1e-30), what

    close(tx.grad, jgx, "input")
    for i, m in enumerate(tmods):
        for name, p in m.named_parameters():
            close(p.grad, jg[i][name], f"layer {i} {name}")


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


def test_fp32_gpt_with_dropout_through_the_split_matches_jax(monkeypatch):
    """The O0 long configuration in miniature: an fp32 GPT with Megatron's
    attention and hidden dropout, JAX's backward forced onto its split
    (its dk/dv and dq kernels ran) and the port's through the split's
    plain versions (dq with the delta fold, then dk/dv, each with the
    layer's seed); JAX's attention seeds and hidden masks recorded in a
    forward of the same rng and replayed: loss within 1e-5 relative,
    every gradient within 1e-4 of its largest value."""
    ps.destroy_model_parallel()
    ids = np.random.RandomState(4).randint(0, SHAPE["vocab_size"],
                                           (GB, GS)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    gpt = jgpt_mod.GPT(jgpt_mod.GPTConfig(
        dtype=jnp.float32, attention_dropout=RATE, hidden_dropout=RATE,
        **SHAPE))
    jparams = jax.device_get(gpt.init(jax.random.PRNGKey(1),
                                      jnp.zeros((1, 8), jnp.int32))["params"])
    key = jax.random.PRNGKey(8)

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
    ran = _spy_jax_kernels(monkeypatch, split=True)
    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jparams))
    assert set(ran) == {"_dkdv_kernel", "_dq_kernel"}

    feed_seeds, feed_masks = list(seeds), list(masks)
    tflash = tgpt_mod.flash_attention

    def replay_seed(*a, dropout_rate, dropout_seed, **kw):
        assert dropout_rate == RATE and dropout_seed is not None
        return tflash(*a, dropout_rate=dropout_rate,
                      dropout_seed=feed_seeds.pop(0), **kw)

    def replay_mask(self, y, rngs):
        if rngs is None:
            return y
        keep = torch.from_numpy(feed_masks.pop(0))
        assert keep.shape == y.shape
        return torch.where(keep, y / (1.0 - RATE), torch.zeros_like(y))

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

    monkeypatch.setattr(tgpt_mod, "flash_attention", replay_seed)
    monkeypatch.setattr(GPT, "_hdrop", replay_mask)
    monkeypatch.setattr(tfa, "flash_attention_bwd_reference", split_bwd)
    model = GPT.params_from_jax(
        GPTConfig(dtype=F32, attention_dropout=RATE, hidden_dropout=RATE,
                  **SHAPE), jparams, device="cpu")
    loss = model.loss(torch.from_numpy(ids), torch.from_numpy(labels),
                      deterministic=False,
                      generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert not feed_seeds and not feed_masks
    assert split_calls == list(reversed(seeds))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jflat = _flat(jax.device_get(jg))
    for name, p in model.named_parameters():
        ref = jflat[name]
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 1e-4 * max(float(np.abs(ref).max()), 1e-30), name
