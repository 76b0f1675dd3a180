"""The additive bias together with attention dropout in the port's flash
attention, against the JAX package, on the CPU.

The JAX kernels take the bias and the dropout in one call
(``apex_tpu/ops/flash_attention.py``: the forward adds the bias, then
drops p, :282-339; the backward recomputes p with its bias and applies
``_p_dp_ds``'s dropout rule, :500-555). The port's plain versions with
``bias=`` and ``dropout_rate``/``dropout_seed`` together — the forward
(``flash_attention_reference``), the single pass
(``flash_attention_bwd_reference``) and the split
(``flash_bwd_dq_reference`` with the delta it folds in,
``flash_bwd_dkdv_reference`` from that delta), which the card holds the
kernels' variants with both against — give out, lse, dq, dk and dv
against the JAX kernels in Pallas interpret mode, on its single pass and
forced onto its split (``_FUSED_BWD_MAX_KV_BYTES`` = 0; a spy records that
its ``_dkdv_kernel`` and ``_dq_kernel`` ran; nothing in the JAX package
changes), with the same numpy inputs and seed, over the four broadcast
shapes of the bias, sq != sk, segment ids, causal and not, -inf entries
and a row that is -inf everywhere (out and dq exactly 0, no NaN): fp32
within 1e-5 of the largest value (lse 1e-5); bf16 operands within two bf16
ulps plus 4e-3 (out) and plus 2 % of the largest gradient (the Pallas
kernels round p and ds to bf16 before their products, the plain versions
keep fp32 but for the dropped p before the PV product).

``SelfMultiheadAttn(use_bias=True, include_norm_add=True, impl="fast",
dropout=0.1)`` in training under fairseq's future mask and key padding:
JAX's attention seed and its output-dropout mask are recorded and replayed
into the port's module, whose output, input gradient and every parameter
gradient then agree within 1e-5 of the largest value.

The CUDA wrappers, with the library stubbed (no card): the forward, dq and
dk/dv entries each receive the bias pointer and strides and the seed,
threshold and 1 / (1 - rate); only the counters of the variants with
both move; the bias's gradient is exactly zero; the single pass takes both
(its variant with both, on its own counter), and so does the fp32 FFMA
route; frag.cuh refuses the pair before any call.
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
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

B, H, DH = 2, 2, 16
RATE, SEED = 0.3, -12345


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


def _bias(rng, shape, sq, sk, neg_inf, dead):
    """A random bias; with ``neg_inf`` a future mask in the first head (or
    the only one), random -inf entries elsewhere, key 0 finite in every
    row; with ``dead`` that row -inf everywhere."""
    bias = rng.randn(*shape, sq, sk).astype(np.float32)
    if neg_inf:
        bias[:, 0][:, np.triu(np.ones((sq, sk), bool), 1)] = -np.inf
        bias[:, 1:][rng.rand(*bias[:, 1:].shape) < 0.3] = -np.inf
        bias[..., 0] = 0.0
    if dead is not None:
        bias[:, :, dead] = -np.inf
    return bias


def _close(got, ref, what, dtype, out=False):
    """fp32: 1e-5 of the largest value; bf16: two bf16 ulps plus 4e-3 (an
    output) or plus 2 % of the largest value (a gradient)."""
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    big = float(np.abs(ref).max())
    if dtype == "float32":
        np.testing.assert_allclose(g, ref, atol=1e-5 * max(1.0, big),
                                   rtol=0, err_msg=what)
        return
    tol = np.abs(ref) * 2 * 2.0 ** -7 + (4e-3 if out else 2e-2 * big)
    assert np.all(np.abs(g - ref) <= tol), (what,
                                            float(np.abs(g - ref).max()))


# (bias dims, causal, sq, sk, segment ids, -inf entries, dead row, dtype,
# also against JAX's single pass)
CASES = [
    ((1, 1), False, 32, 32, False, False, None, "float32", True),
    ((1, H), True, 32, 32, False, False, None, "float32", False),
    ((B, 1), False, 24, 40, False, False, None, "float32", True),  # sq != sk
    ((B, H), True, 40, 24, False, False, None, "float32", False),  # sq > sk
    ((B, H), True, 32, 32, True, True, None, "float32", False),    # segments
    ((1, H), False, 32, 32, False, True, 5, "float32", True),      # dead row
    ((1, H), True, 32, 32, False, True, 3, "bfloat16", False),
]


@pytest.mark.parametrize(
    "bias_shape,causal,sq,sk,seg,neg_inf,dead,dtype,single", CASES)
def test_plain_versions_with_bias_and_dropout_match_jax(
        bias_shape, causal, sq, sk, seg, neg_inf, dead, dtype, single,
        monkeypatch):
    rng = np.random.RandomState(21)
    q, do = (rng.randn(B, H, sq, DH).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, sk, DH).astype(np.float32) for _ in range(2))
    bias = _bias(rng, bias_shape, sq, sk, neg_inf, dead)
    scale = DH ** -0.5
    kw, tkw = dict(causal=causal), dict(causal=causal)
    sid = None
    if seg:
        sid = np.zeros((B, sq), np.int32)
        sid[0, sq - 3:] = -1                              # padding rows
        sid[1, sq // 2:] = 1
        kw["segment_ids_q"] = jnp.asarray(sid)
        tkw["segment_ids_q"] = torch.from_numpy(sid)
    if dtype == "bfloat16":
        jarr = [jnp.asarray(a.astype(ml_dtypes.bfloat16))
                for a in (q, k, v, do)]
        tarr = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    else:
        jarr = [jnp.asarray(a) for a in (q, k, v, do)]
        tarr = [torch.from_numpy(a) for a in (q, k, v, do)]

    def jf(qq, kk, vv):
        return jfa.flash_attention(qq, kk, vv, bias=jnp.asarray(bias),
                                   scale=scale, dropout_rate=RATE,
                                   dropout_seed=SEED, block_q=16, block_k=16,
                                   block_q_bwd=16, block_k_bwd=16,
                                   interpret=True, autotune="off", **kw)

    single_grads = None
    if single:
        _, vjp = jax.vjp(jf, *jarr[:3])
        single_grads = [np.asarray(g, np.float32) for g in vjp(jarr[3])]
    ran = _force_jax_split(monkeypatch)
    jout, vjp = jax.vjp(jf, *jarr[:3])
    jgrads = [np.asarray(g, np.float32) for g in vjp(jarr[3])]
    assert set(ran) == {"_dkdv_kernel", "_dq_kernel"}
    jout = np.asarray(jout, np.float32)
    _, jlse = jfa._flash_fwd_impl(
        *jarr[:3], kw.get("segment_ids_q"), None, jnp.asarray(bias),
        jnp.asarray([SEED], jnp.int32), scale, causal, RATE, 16, 16, True)

    tq, tk, tv, tdo = tarr
    both = dict(scale=scale, bias=torch.from_numpy(bias), dropout_rate=RATE,
                dropout_seed=SEED, **tkw)
    out, lse = tfa.flash_attention_reference(tq, tk, tv, **both)
    _close(out, jout, "out", dtype, out=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=1e-5)
    dq, delta = tfa.flash_bwd_dq_reference(tq, tk, tv, out, lse, tdo, **both)
    dk, dv = tfa.flash_bwd_dkdv_reference(tq, tk, tv, lse, delta, tdo,
                                          **both)
    want = (tdo.float() * out.float()).sum(-1)
    np.testing.assert_allclose(delta.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), jgrads):
        assert got.dtype == tq.dtype and bool(torch.isfinite(got).all())
        _close(got, ref, f"split {name}", dtype)
    grads = tfa.flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo,
                                              **both)
    if single_grads is not None:
        for name, got, ref in zip(("dq", "dk", "dv"), grads, single_grads):
            _close(got, ref, f"single pass {name}", dtype)
    # the split's plain versions compose to the single pass's, bitwise
    for got, ref in zip((dq, dk, dv), grads):
        assert torch.equal(got, ref)
    if dead is not None:
        assert bool((lse[:, :, dead] == -1e30).all())
        assert torch.count_nonzero(out[:, :, dead]).item() == 0
        assert torch.count_nonzero(dq[:, :, dead]).item() == 0
        np.testing.assert_array_equal(jout[:, :, dead], 0.0)
        np.testing.assert_array_equal(jgrads[0][:, :, dead], 0.0)


def test_bias_and_dropout_each_move_the_result():
    """With both, the output and every gradient differ from those with the
    bias alone and with dropout alone: both are applied."""
    g = torch.Generator().manual_seed(21)
    b, h, s, d = 2, 2, 24, 16
    q, k, v, do = (torch.randn(b, h, s, d, generator=g) for _ in range(4))
    bias = torch.randn(1, h, s, s, generator=g)
    kw = dict(causal=True)
    runs = {}
    for name, extra in (("both", dict(bias=bias, dropout_rate=RATE,
                                      dropout_seed=SEED)),
                        ("bias", dict(bias=bias)),
                        ("dropout", dict(dropout_rate=RATE,
                                         dropout_seed=SEED))):
        out, lse = tfa.flash_attention_reference(q, k, v, **kw, **extra)
        runs[name] = (out, *tfa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, **kw, **extra))
    for other in ("bias", "dropout"):
        for got, ref in zip(runs["both"], runs[other]):
            assert not torch.allclose(got, ref)


E, HEADS, S = 32, 4, 16


def test_self_multihead_attn_with_mask_and_dropout_replays_jax(monkeypatch):
    """The fast path at dropout 0.1 with norm_add in training, under
    fairseq's future mask [S, S] and key padding: JAX's module (its
    backward forced onto the split) draws its attention seed and its
    output-dropout mask from its ``dropout`` rng; both are recorded and
    replayed into the port's module (the seed into ``prep_fast_path``'s
    result, the mask into its plain output dropout), and the outputs, the
    input's and every parameter's gradients agree."""
    rng = np.random.RandomState(34)
    x = rng.randn(S, B, E).astype(np.float32)
    dout = rng.randn(S, B, E).astype(np.float32)
    mask = np.triu(np.full((S, S), -np.inf, np.float32), 1)
    pad = np.zeros((B, S), bool)
    pad[1, S - 5:] = True
    opts = dict(dropout=0.1, use_bias=True, include_norm_add=True,
                impl="fast")
    jm = jmha.SelfMultiheadAttn(E, HEADS, **opts)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(x),
                     is_training=False)["params"]
    seeds, masks = [], []
    jflash, bernoulli = jself_mod.flash_attention, stochastic.random.bernoulli

    def record_seed(*a, **kw):
        seeds.append(int(jax.device_get(kw["dropout_seed"])))
        assert kw["bias"] is not None and kw["dropout_rate"] == 0.1
        return jflash(*a, **kw)

    def record_mask(*a, **kw):
        keep = bernoulli(*a, **kw)
        masks.append(np.array(keep))
        return keep

    monkeypatch.setattr(jself_mod, "flash_attention", record_seed)
    monkeypatch.setattr(stochastic.random, "bernoulli", record_mask)
    ran = _force_jax_split(monkeypatch)

    def jf(p, xx):
        return jm.apply({"params": p}, xx, key_padding_mask=jnp.asarray(pad),
                        attn_mask=jnp.asarray(mask), is_training=True,
                        rngs={"dropout": jax.random.PRNGKey(9)})

    jout, vjp = jax.vjp(jf, params, jnp.asarray(x))
    jgrads = vjp(jnp.asarray(dout))
    monkeypatch.setattr(stochastic.random, "bernoulli", bernoulli)
    assert len(seeds) == 1 and len(masks) == 1
    assert set(ran) == {"_dkdv_kernel", "_dq_kernel"}

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
    # the dropout moved the output: not the deterministic module's
    det = tm(tx.detach(), key_padding_mask=torch.from_numpy(pad),
             attn_mask=torch.from_numpy(mask), is_training=False)
    assert not torch.allclose(out.detach(), det, atol=1e-3)


# ---------------------------------------------------------------------------
# the CUDA wrappers' C calls (the library stubbed: no card)
# ---------------------------------------------------------------------------

def _stub_library(monkeypatch):
    """The C calls the wrappers make, recorded instead of run (CPU tensors
    stand for the card's): ``(target, symbol, args)``; the device check
    answers CUDA. The flash launch counters get their values back at the
    test's end, so that no other test in the process sees these calls."""
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
    return dict(
        fwd_both=f.bias_dropout_launches, fwd_bias=f.bias_launches,
        fwd_drop=f.dropout_launches, dkdv_both=g.bias_dropout_dkdv_launches,
        dq_both=g.bias_dropout_dq_launches, dkdv_bias=g.bias_dkdv_launches,
        dq_bias=g.bias_dq_launches, dkdv_drop=g.dropout_dkdv_launches,
        dq_drop=g.dropout_dq_launches, single=g.launches,
        single_bias=g.bias_launches, single_drop=g.dropout_launches,
        single_both=g.bias_dropout_fused_launches)


@pytest.mark.parametrize("d,s", [(64, 512), (128, 448)])
def test_cuda_wrappers_pass_the_bias_and_the_dropout_together(monkeypatch,
                                                              d, s):
    """The shortest square contexts the gate splits with both (2.49 MB at
    s512 d64, 2.29 MB at s448 d128): through ``flash_attention`` the
    forward, then the split's dq and dk/dv, each handed the bias pointer
    and its strides and the dropout's seed, threshold and 1 / (1 - rate);
    only the counters of the variants with both move; dbias is exactly
    zero in the bias's own shape and dtype."""
    calls = _stub_library(monkeypatch)
    b, h = 2, 3
    assert tfa.uses_split_backward(s, s, d, bias=True, dropout=True)
    q = torch.zeros(b, h, s, d, dtype=torch.bfloat16, requires_grad=True)
    bias = torch.zeros(1, h, s, s, dtype=torch.bfloat16, requires_grad=True)
    n0 = _counts()
    out = tfa.flash_attention(q, q, q, bias=bias, dropout_rate=0.1,
                              dropout_seed=-7)
    out.float().sum().backward()
    assert [c[1] for c in calls] == ["apex_flash_fwd_sm90",
                                     "apex_flash_bwd_sm90_dq",
                                     "apex_flash_bwd_sm90_dkdv"]
    drop = tfa._dropout_args(0.1, -7)
    assert drop[1] > 0
    for _, symbol, args in calls:
        ptr, sb, sh = args[-7:-4]
        assert ptr.value is not None and (sb, sh) == (0, s * s), symbol
        assert args[-4:-1] == drop, symbol
    moved = {k: v - n0[k] for k, v in _counts().items()}
    assert moved == dict(fwd_both=1, fwd_bias=0, fwd_drop=0, dkdv_both=1,
                         dq_both=1, dkdv_bias=0, dq_bias=0, dkdv_drop=0,
                         dq_drop=0, single=0, single_bias=0, single_drop=0,
                         single_both=0)
    assert bias.grad is not None and bias.grad.dtype == torch.bfloat16
    assert tuple(bias.grad.shape) == (1, h, s, s)
    assert torch.count_nonzero(bias.grad).item() == 0


def test_the_single_pass_refuses_both_before_any_call(monkeypatch):
    """The single pass takes both now: s448 at d 64 with both stays under
    the gate (1.95 MB), and through ``flash_attention`` the forward's and
    the single pass's variants with both run, each handed the bias and the
    dropout, on the counters of the variants with both alone; the backward
    forced onto the single pass, and the single pass's wrapper called
    alone, launch it too. The fp32 FFMA route takes the bias with dropout
    too (s448 at d 64 stays on its single pass: fp32 with both splits from
    s452), its forward's and single pass's C entries each handed both,
    and the bias alone; frag.cuh (fp32 at kernel head dim 256) still
    refuses the pair before any call, grads wanted or not."""
    calls = _stub_library(monkeypatch)
    s, d = 448, 64
    assert not tfa.uses_split_backward(s, s, d, bias=True, dropout=True)
    q = torch.zeros(1, 2, s, d, dtype=torch.bfloat16, requires_grad=True)
    bias = torch.zeros(1, 1, s, s)
    kw = dict(bias=bias, dropout_rate=0.1, dropout_seed=3)
    drop = tfa._dropout_args(0.1, 3)
    n0 = _counts()
    tfa.flash_attention(q, q, q, **kw).float().sum().backward()
    assert [c[1] for c in calls] == ["apex_flash_fwd_sm90",
                                     "apex_flash_bwd_sm90_fused"]
    for _, symbol, args in calls:
        assert args[-7].value is not None and args[-4:-1] == drop, symbol
    moved = {k: v - n0[k] for k, v in _counts().items()}
    assert moved == dict(fwd_both=1, fwd_bias=0, fwd_drop=0, dkdv_both=0,
                         dq_both=0, dkdv_bias=0, dq_bias=0, dkdv_drop=0,
                         dq_drop=0, single=1, single_bias=0, single_drop=0,
                         single_both=1)
    calls.clear()
    qs = torch.zeros(1, 2, 1024, d, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 1024)
    tfa._flash_bwd_cuda(qs, qs, qs, qs, lse, qs, None, None, True, 0.125,
                        split=False, bias=torch.zeros(1, 1, 1024, 1024),
                        dropout_rate=0.1, dropout_seed=3)
    bop = tfa._bias_operand(torch.zeros(1, 1, 1024, 1024), 1, 2, 1024, 1024,
                            qs.device)
    tfa._flash_bwd_fused_cuda(qs, qs, qs, qs, lse, lse, None, None, True,
                              0.125, torch.zeros(qs.shape), dropout=drop,
                              bias=bop)
    assert [c[1] for c in calls] == ["apex_flash_bwd_sm90_fused"] * 2
    assert all(c[2][-4:-1] == drop and c[2][-7].value is not None
               for c in calls)
    assert _counts()["single_both"] - n0["single_both"] == 3
    calls.clear()
    q32 = torch.zeros(1, 2, s, d, requires_grad=True)
    extra = dict(dropout_rate=0.1, dropout_seed=3)
    tfa.flash_attention(q32, q32, q32, bias=bias, **extra).sum().backward()
    assert [c[1] for c in calls] == ["apex_flash_fwd_f32",
                                     "apex_flash_bwd_f32"]
    assert all(c[2][-7].value is not None and c[2][-4:-1] == drop
               for c in calls)
    calls.clear()
    q256 = torch.zeros(1, 2, s, 256, requires_grad=True)
    with pytest.raises(NotImplementedError, match="frag.cuh"):
        tfa.flash_attention(q256, q256, q256, bias=bias, **extra)
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match="frag.cuh"):
        tfa.flash_attention(q256, q256, q256, bias=bias, **extra)
    assert calls == []
    tfa.flash_attention(q32, q32, q32, bias=bias).sum().backward()
    assert [c[1] for c in calls] == ["apex_flash_fwd_f32",
                                     "apex_flash_bwd_f32"]
    assert all(c[2][-7].value is not None and c[2][-4:-1] == (0, 0, 1.0)
               for c in calls)
