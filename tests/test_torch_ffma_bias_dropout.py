"""The fp32 FFMA route with the additive bias and attention dropout
together (the forward, the single pass and the split's dk/dv and dq), and
rows whose bias sits at the -1e30 fill, on the CPU.

The route table: ``bias_refusal`` and ``dropout_refusal`` take fp32 at
kernel head dims 64 and 128 on the FFMA route, so the backward's route
takes the two together, split or not (the gate counts both as the JAX
gate does: fp32 splits from s452 at d 64 and from s400 at d 128); the
frag.cuh kernels (fp32 at d 32/256/512, fp32 over narrower operands, bf16
at d 32) still refuse the pair, naming themselves.

The CUDA wrappers, with the library stubbed (no card): each of the four
FFMA C entries (``apex_flash_fwd_f32``, ``apex_flash_bwd_f32``,
``apex_flash_bwd_f32_dkdv``, ``apex_flash_bwd_f32_dq``) gets the bias
pointer and strides and a nonzero keep threshold in one call, the single
pass and the split forced each way; only the counters of the variants
with both move beside the route's own.

Against the JAX package: a 2-layer fp32 stack of ``SelfMultiheadAttn(
dropout=0.1, use_bias=True, include_norm_add=True, impl="fast")`` in
training under fairseq's future mask and key padding, JAX's backward on
its single pass and forced onto its split (``_FUSED_BWD_MAX_KV_BYTES`` =
0, a spy recording which kernels ran; nothing in the JAX package
changes), each layer's attention seed and output-dropout mask recorded and
replayed into the port's modules: out and every gradient within 1e-5 of
the largest value. Rows whose bias is -1e30 or -8e29 on every key the
causal mask keeps: the port's plain forward and backward against the JAX
kernels in interpret mode (its single pass and its forced split). Such a
row is live: its out is the mean of v over the kept keys (the dropped mean
with dropout), its lse the fill, and the backward takes p = 1 on each kept
key, as the JAX backward does (log(l) is lost at 1e30, so this is not the
forward's exact derivative; the port follows the reference).
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
from apex_tpu_torch.contrib import multihead_attn as tmha
from apex_tpu_torch.contrib.multihead_attn import self_multihead_attn as \
    tself_mod
from apex_tpu_torch.ops import flash_attention as tfa

# ``apex_tpu.ops`` re-exports a function of the same name as the module
jfa = importlib.import_module("apex_tpu.ops.flash_attention")

F32, BF = torch.float32, torch.bfloat16


# ---------------------------------------------------------------------------
# the route table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kd,first", [(64, 452), (128, 400)])
@pytest.mark.parametrize("causal", [False, True])
def test_the_ffma_route_takes_the_bias_with_dropout(kd, first, causal):
    """fp32 at kernel head dims 64 and 128: the bias with dropout takes the
    FFMA route, on the single pass below the gate's first split length and
    on the split from it."""
    assert tfa.bias_refusal(F32, kd) is None
    assert tfa.dropout_refusal(F32, kd) is None
    for s in (first - 1, first):
        q = torch.zeros(1, 1, s, kd)
        assert tfa._bwd_route(q, q, q, causal, 0.1, bias=True) == (
            s >= first, F32)


@pytest.mark.parametrize("dtype,kd,ffma", [
    (F32, 32, True), (F32, 256, True), (F32, 512, True), (F32, 64, False),
    (BF, 32, True)])
def test_frag_routes_still_refuse_the_bias_with_dropout(dtype, kd, ffma):
    """frag.cuh takes neither the bias nor dropout, so not the pair: the
    refusal names it, before the forward where grads are wanted."""
    assert "frag.cuh" in tfa.bias_refusal(dtype, kd, ffma)
    assert "frag.cuh" in tfa.dropout_refusal(dtype, kd, ffma)
    q = torch.zeros(1, 1, 64, kd, dtype=dtype)
    k = q if ffma else q.to(BF)      # narrower operands round p and ds
    with pytest.raises(NotImplementedError, match="bias.*frag.cuh"):
        tfa._bwd_route(q, k, k, True, 0.1, bias=True)


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
    return {f"{fn.__name__}.{name}": value
            for fn in (tfa.flash_attention, tfa.flash_attention_bwd)
            for name, value in vars(fn).items() if name.endswith("launches")}


FWD, BWD = "flash_attention", "flash_attention_bwd"


@pytest.mark.parametrize("kd", [64, 128])
@pytest.mark.parametrize("split", [False, True])
def test_ffma_entries_get_the_bias_and_the_dropout_together(monkeypatch, kd,
                                                            split):
    """The forward's entry and the backward's (the single pass, or the
    split's dk/dv then dq, forced either way at s256) each get the bias
    [1, 2, s, s] (a broadcast batch: stride 0, head stride s * s) and
    (seed, threshold, inv) with a nonzero threshold in one call; only the
    counters with both move beside the route's own."""
    calls = _stub_library(monkeypatch)
    s = 256
    q = torch.zeros(2, 2, s, kd)
    bias = torch.zeros(1, 2, s, s)
    drop = tfa._dropout_args(0.1, 41)
    assert drop[1] > 0
    kw = dict(bias=bias, dropout_rate=0.1, dropout_seed=41)
    n0 = _counts()
    out, lse = tfa._flash_fwd_cuda(q, q, q, None, None, True, 0.125, **kw)
    tfa._flash_bwd_cuda(q, q, q, out, lse, q, None, None, True, 0.125,
                        split=split, **kw)
    symbols = ["apex_flash_fwd_f32"] + (
        ["apex_flash_bwd_f32_dkdv", "apex_flash_bwd_f32_dq"] if split
        else ["apex_flash_bwd_f32"])
    assert [c[1] for c in calls] == symbols
    for target, symbol, args in calls:
        assert target == ("flash_fwd@f32" if "fwd" in symbol
                          else "flash_bwd@f32"), symbol
        ptr, sb, sh = args[-7:-4]
        assert ptr is not None and (sb, sh) == (0, s * s), symbol
        assert args[-4:-1] == drop and args[-1] is None, symbol
    want = {f"{FWD}.launches": 1, f"{FWD}.f32_launches": 1,
            f"{FWD}.f32_bias_dropout_launches": 1}
    if split:
        want.update({f"{BWD}.dkdv_launches": 1, f"{BWD}.dq_launches": 1,
                     f"{BWD}.f32_dkdv_launches": 1,
                     f"{BWD}.f32_dq_launches": 1,
                     f"{BWD}.f32_bias_dropout_dkdv_launches": 1,
                     f"{BWD}.f32_bias_dropout_dq_launches": 1})
    else:
        want.update({f"{BWD}.launches": 1, f"{BWD}.f32_launches": 1,
                     f"{BWD}.f32_bias_dropout_launches": 1})
    moved = {k: v - n0[k] for k, v in _counts().items() if v != n0[k]}
    assert moved == want


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


E, HEADS, S, B, LAYERS, RATE = 32, 4, 32, 2, 2, 0.1


@pytest.mark.parametrize("split", [False, True])
def test_fp32_mha_stack_with_the_mask_and_dropout_matches_jax(monkeypatch,
                                                              split):
    """Two fp32 ``SelfMultiheadAttn(dropout=0.1, use_bias=True,
    include_norm_add=True, impl="fast")`` layers in sequence, in training
    under fairseq's future mask [S, S] and key padding: JAX's on its single
    pass or its forced split (the spy shows which ran), each layer's
    attention seed and output-dropout mask recorded and replayed into the
    port's layers in order; the output, the input's and every parameter's
    gradients within 1e-5 of the largest value."""
    rng = np.random.RandomState(29)
    x = rng.randn(S, B, E).astype(np.float32)
    dout = rng.randn(S, B, E).astype(np.float32)
    mask = np.triu(np.full((S, S), -np.inf, np.float32), 1)
    pad = np.zeros((B, S), bool)
    pad[1, S - 7:] = True
    opts = dict(dropout=RATE, use_bias=True, include_norm_add=True,
                impl="fast")
    jmods = [jmha.SelfMultiheadAttn(E, HEADS, **opts) for _ in range(LAYERS)]
    params = [m.init(jax.random.PRNGKey(50 + i), jnp.asarray(x),
                     is_training=False)["params"]
              for i, m in enumerate(jmods)]
    seeds, masks = [], []
    jflash, bernoulli = jself_mod.flash_attention, stochastic.random.bernoulli

    def record_seed(*a, **kw):
        seeds.append(int(jax.device_get(kw["dropout_seed"])))
        assert kw["bias"] is not None and kw["dropout_rate"] == RATE
        return jflash(*a, **kw)

    def record_mask(*a, **kw):
        keep = bernoulli(*a, **kw)
        masks.append(np.array(keep))
        return keep

    monkeypatch.setattr(jself_mod, "flash_attention", record_seed)
    monkeypatch.setattr(stochastic.random, "bernoulli", record_mask)
    ran = _spy_jax_kernels(monkeypatch, split)

    def jf(ps_, xx):
        for i, (m, p) in enumerate(zip(jmods, ps_)):
            xx = m.apply({"params": p}, xx, is_training=True,
                         attn_mask=jnp.asarray(mask),
                         key_padding_mask=jnp.asarray(pad),
                         rngs={"dropout": jax.random.PRNGKey(70 + i)})
        return xx

    jout, vjp = jax.vjp(jf, params, jnp.asarray(x))
    jg, jgx = vjp(jnp.asarray(dout))
    monkeypatch.setattr(stochastic.random, "bernoulli", bernoulli)
    assert len(seeds) == LAYERS and len(masks) == LAYERS
    assert set(ran) == ({"_dkdv_kernel", "_dq_kernel"} if split
                        else {"_bwd_fused_kernel"})

    prep, feed_seeds, feed_masks = tself_mod.prep_fast_path, list(seeds), \
        list(masks)

    def replay_seed(*a, **kw):
        sid_q, sid_kv, bias, rate, _ = prep(*a, **kw)
        assert rate == RATE and bias is not None
        return sid_q, sid_kv, bias, rate, feed_seeds.pop(0)

    def replay_mask(t, rate, gen):
        keep = torch.from_numpy(feed_masks.pop(0))
        return torch.where(keep, t / (1.0 - rate), torch.zeros_like(t))

    monkeypatch.setattr(tself_mod, "prep_fast_path", replay_seed)
    monkeypatch.setattr(tself_mod, "dropout", replay_mask)
    tmods = [tmha.SelfMultiheadAttn.params_from_jax(
        E, HEADS, {n: np.asarray(a) for n, a in jax.device_get(p).items()},
        device="cpu", **opts) for p in params]
    tx = torch.from_numpy(x).requires_grad_()
    y = tx
    for m in tmods:
        y = m(y, key_padding_mask=torch.from_numpy(pad),
              attn_mask=torch.from_numpy(mask),
              generator=torch.Generator().manual_seed(0))
    y.backward(torch.from_numpy(dout))
    assert not feed_seeds and not feed_masks

    def close(got, ref, what):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.detach().numpy(), ref,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   rtol=0, err_msg=what)

    close(y, jout, "out")
    close(tx.grad, jgx, "input")
    for i, m in enumerate(tmods):
        for name, p in m.named_parameters():
            close(p.grad, jg[i][name], f"layer {i} {name}")


# rows of the fill case: the bias at the -1e30 fill and just above it on
# every key (the causal mask keeps keys 0..row), and a row -inf everywhere
FILL_ROWS = {3: -1e30, 9: -1e30, 5: -8e29, 12: -8e29}
DEAD_ROW = 7
FB, FH, FS, FD = 2, 2, 32, 16


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("split", [False, True])
def test_plain_fill_rows_match_jax(monkeypatch, rate, split):
    """Rows whose bias is -1e30 or -8e29 on every key the causal mask
    keeps, beside finite rows and a row -inf everywhere, in fp32: the
    port's plain forward against the JAX kernels in interpret mode (out
    1e-5 of the largest value, lse 1e-5 relative), its plain backward
    against JAX's single pass or forced split (1e-5 of the largest
    gradient). A fill row is live: without dropout its out is the mean of
    v over the kept keys, and the backward's p is exactly 1 on each kept
    key (0 past the mask), as JAX recomputes it from lse = the fill. The
    -inf row is dead: out and dq exactly 0, lse the fill."""
    rng = np.random.RandomState(31)
    q, k, v, do = (rng.randn(FB, FH, FS, FD).astype(np.float32)
                   for _ in range(4))
    bias = rng.randn(1, FH, FS, FS).astype(np.float32)
    for row, fill in FILL_ROWS.items():
        bias[:, :, row] = fill
    bias[:, :, DEAD_ROW] = -np.inf
    scale = FD ** -0.5
    seed = 2024

    def jf(qq, kk, vv):
        return jfa.flash_attention(qq, kk, vv, bias=jnp.asarray(bias),
                                   causal=True, scale=scale,
                                   dropout_rate=rate,
                                   dropout_seed=seed if rate else None,
                                   block_q=16, block_k=16, block_q_bwd=16,
                                   block_k_bwd=16, interpret=True,
                                   autotune="off")

    ran = _spy_jax_kernels(monkeypatch, split)
    jarr = [jnp.asarray(a) for a in (q, k, v, do)]
    jout, vjp = jax.vjp(jf, *jarr[:3])
    jgrads = [np.asarray(g, np.float32) for g in vjp(jarr[3])]
    assert set(ran) == ({"_dkdv_kernel", "_dq_kernel"} if split
                        else {"_bwd_fused_kernel"})
    _, jlse = jfa._flash_fwd_impl(
        *jarr[:3], None, None, jnp.asarray(bias),
        jnp.asarray([seed], jnp.int32), scale, True, rate, 16, 16, True)
    jout, jlse = np.asarray(jout, np.float32), np.asarray(jlse)

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    kw = dict(causal=True, scale=scale, bias=torch.from_numpy(bias),
              dropout_rate=rate, dropout_seed=seed if rate else None)
    out, lse = tfa.flash_attention_reference(tq, tk, tv, **kw)
    big = max(1.0, float(np.abs(jout).max()))
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-5 * big, rtol=0)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=1e-5, atol=1e-5)
    rows = sorted(FILL_ROWS)
    assert bool((lse[:, :, rows] <= -8e29 * (1 - 1e-6)).all())
    if not rate:
        mean = np.stack([v[:, :, :r + 1].mean(axis=2) for r in rows], 2)
        np.testing.assert_allclose(out[:, :, rows].numpy(), mean, rtol=0,
                                   atol=1e-6)
    p = tfa._bwd_probs(tq, tk, lse, True, None, None, scale,
                       torch.from_numpy(bias))
    kept = torch.ones(FS, FS).tril().bool()
    for r in rows:
        assert torch.equal(p[:, :, r], kept[r].float().expand(FB, FH, FS))
    grads = tfa.flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo, **kw)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, jgrads):
        assert bool(torch.isfinite(got).all()), name
        np.testing.assert_allclose(
            got.numpy(), ref, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=name)
    assert bool(grads[0][:, :, rows].abs().max() > 0)
    assert bool((lse[:, :, DEAD_ROW] == -1e30).all())
    assert torch.count_nonzero(out[:, :, DEAD_ROW]).item() == 0
    assert torch.count_nonzero(grads[0][:, :, DEAD_ROW]).item() == 0
    np.testing.assert_array_equal(jout[:, :, DEAD_ROW], 0.0)
