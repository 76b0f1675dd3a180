"""The port's flash attention under an additive bias against the JAX op.

The bias is an additive mask, non-differentiable by contract: the JAX
op's backward returns ``zeros_like(bias)`` for it (``_fa_bwd``). The
port's CPU route (``BiasedAttentionFunction``) must give the same: an
exactly zero bias gradient in the bias's own broadcast shape, and dq, dk
and dv within 1e-5 of ``jax.grad`` through
``apex_tpu.ops.flash_attention.flash_attention`` (Pallas interpret mode
on the CPU). Inputs from numpy seeds, fp32 on both sides.

The plain versions the card's bias variants are held against
(``flash_attention_reference`` and ``flash_attention_bwd_reference`` with
``bias``) give out, lse, dq, dk and dv against the JAX kernels in
interpret mode over the four broadcast shapes, sq != sk, segment ids,
causal and not, -inf entries and a row that is -inf everywhere (out
exactly 0, lse -1e30, no NaN): fp32 within 1e-5 (out, lse) and 1e-5 of the
largest gradient; bf16 operands within two bf16 ulps plus 4e-3 (out: the
JAX kernel rounds p to bf16 before the PV product, the plain version does
not) and two bf16 ulps plus 2 % of the largest gradient (the JAX kernel
rounds p and ds to bf16 before its products). The gate counts the bias as
the JAX gate does, ``bias_refusal`` names every route that still refuses
it (the split takes it, and the wgmma route takes it with dropout but for
the single pass), and the CUDA wrappers' C calls (the library stubbed: no
card needed) carry the fp32 bias with its broadcast strides, never
expanded.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jfa = importlib.import_module("apex_tpu.ops.flash_attention")
from apex_tpu_torch.ops import flash_attention as tfa

S, D = 16, 16


def _inputs(b, h, bias_shape, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, h, S, D).astype(np.float32)
                   for _ in range(4))
    bias = rng.randn(*bias_shape).astype(np.float32)
    return q, k, v, do, bias


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,bias_shape", [
    (1, 2, (1, 2, S, S)),       # one bias a head, shared by the batch
    (2, 2, (2, 1, S, S)),       # one bias a sequence, shared by the heads
])
def test_bias_grads_match_jax_and_dbias_is_zero(b, h, bias_shape, causal):
    q, k, v, do, bias = _inputs(b, h, bias_shape, seed=11)

    def jloss(q_, k_, v_, bias_):
        out = jfa.flash_attention(q_, k_, v_, causal=causal, bias=bias_)
        return jnp.sum(out * jnp.asarray(do))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias))
    tq, tk, tv, tb = (torch.from_numpy(a).requires_grad_()
                      for a in (q, k, v, bias))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, bias=tb)
    out.backward(torch.from_numpy(do))
    for name, got, ref in zip(("dq", "dk", "dv"), (tq.grad, tk.grad,
                                                   tv.grad), jgrads[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0, err_msg=name)
    assert tuple(tb.grad.shape) == bias_shape
    assert np.all(np.asarray(jgrads[3]) == 0.0)
    assert torch.count_nonzero(tb.grad).item() == 0


def test_bias_without_grad_leaves_qkv_grads_and_no_bias_grad():
    q, k, v, do, bias = _inputs(1, 2, (1, 2, S, S), seed=12)
    tq = torch.from_numpy(q).requires_grad_()
    tb = torch.from_numpy(bias)           # a mask: no gradient asked
    out = tfa.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                              bias=tb)
    ref = tfa.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), bias=tb)
    assert torch.equal(out.detach(), ref)
    out.backward(torch.from_numpy(do))
    assert tq.grad is not None and tb.grad is None


def test_bias_of_a_shape_that_does_not_broadcast_raises():
    q = torch.zeros(2, 2, S, D)
    with pytest.raises(ValueError, match="broadcast"):
        tfa.flash_attention(q, q, q, bias=torch.zeros(3, 1, S, S))


# ---------------------------------------------------------------------------
# the plain forward and backward with a bias against the JAX kernels
# ---------------------------------------------------------------------------

B, H, DH = 2, 2, 16


def _segments(b, s):
    sid = np.zeros((b, s), np.int32)
    sid[0, s - 3:] = -1
    sid[1, s // 2:] = 1
    return sid


def _jax_fwd_bwd(q, k, v, do, bias, causal, sid, scale):
    """out, lse and (dq, dk, dv) of the JAX kernels (interpret mode, 16-row
    blocks: the single pass, as the port's bias route)."""
    jsid = None if sid is None else jnp.asarray(sid)
    jbias = jnp.asarray(bias)

    def jf(qq, kk, vv):
        return jfa.flash_attention(
            qq, kk, vv, segment_ids_q=jsid, bias=jbias, causal=causal,
            scale=scale, block_q=16, block_k=16, block_q_bwd=16,
            block_k_bwd=16, interpret=True, autotune="off")

    jout, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    _, jlse = jfa._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jsid, None, jbias,
        jnp.zeros((1,), jnp.int32), scale, causal, 0.0, 16, 16, True)
    return (np.asarray(jout, np.float32), np.asarray(jlse),
            [np.asarray(g, np.float32) for g in jgrads])


def _port_fwd_bwd(q, k, v, do, bias, causal, sid, scale, dtype):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v, do)]
    tsid = None if sid is None else torch.from_numpy(sid)
    tbias = torch.from_numpy(bias)
    out, lse = tfa.flash_attention_reference(
        *t[:3], causal=causal, segment_ids_q=tsid, scale=scale, bias=tbias)
    grads = tfa.flash_attention_bwd_reference(
        *t[:3], out, lse, t[3], causal=causal, segment_ids_q=tsid,
        scale=scale, bias=tbias)
    return out, lse, grads


@pytest.mark.parametrize("bias_shape,causal,sq,sk,seg", [
    ((1, 1), False, 16, 16, False),
    ((1, H), True, 16, 16, False),
    ((B, 1), False, 24, 40, False),      # sq != sk
    ((B, H), True, 40, 24, False),       # sq > sk: rows past sk see no key
    ((1, 1), True, 32, 32, True),        # segment ids with padding
    ((B, H), False, 32, 32, True),
])
def test_plain_bias_forward_and_backward_match_jax(bias_shape, causal, sq,
                                                   sk, seg):
    rng = np.random.RandomState(21)
    q, do = (rng.randn(B, H, sq, DH).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, sk, DH).astype(np.float32) for _ in range(2))
    bias = rng.randn(*bias_shape, sq, sk).astype(np.float32)
    sid = _segments(B, sq) if seg else None
    scale = DH ** -0.5
    jout, jlse, jgrads = _jax_fwd_bwd(q, k, v, do, bias, causal, sid, scale)
    out, lse, grads = _port_fwd_bwd(q, k, v, do, bias, causal, sid, scale,
                                    torch.float32)
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-5, rtol=1e-5)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   rtol=0, err_msg=name)


def _neg_inf_bias(rng, sq, sk, dead_row):
    """A [1, H, sq, sk] bias with -inf entries (a future mask in head 0,
    random -inf in head 1) and one row -inf everywhere in both heads."""
    bias = rng.randn(1, H, sq, sk).astype(np.float32)
    bias[0, 0][np.triu(np.ones((sq, sk), bool), 1)] = -np.inf
    bias[0, 1][rng.rand(sq, sk) < 0.3] = -np.inf
    bias[0, :, :, 0] = 0.0            # every row but the dead one sees a key
    bias[0, :, dead_row] = -np.inf
    return bias


@pytest.mark.parametrize("causal", [False, True])
def test_plain_bias_with_neg_inf_and_a_dead_row_matches_jax(causal):
    rng = np.random.RandomState(22)
    s, dead = 32, 5
    q, k, v, do = (rng.randn(B, H, s, DH).astype(np.float32)
                   for _ in range(4))
    bias = _neg_inf_bias(rng, s, s, dead)
    scale = DH ** -0.5
    jout, jlse, jgrads = _jax_fwd_bwd(q, k, v, do, bias, causal, None,
                                      scale)
    out, lse, grads = _port_fwd_bwd(q, k, v, do, bias, causal, None, scale,
                                    torch.float32)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert all(torch.isfinite(g).all() for g in grads)
    assert torch.count_nonzero(out[:, :, dead]).item() == 0
    assert bool((lse[:, :, dead] == -1e30).all())
    assert torch.count_nonzero(grads[0][:, :, dead]).item() == 0
    np.testing.assert_array_equal(jout[:, :, dead], 0.0)
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-5, rtol=1e-5)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   rtol=0, err_msg=name)


def test_plain_bias_in_bf16_matches_jax_within_the_bf16_limits():
    """bf16 operands: both sides take the same bf16 inputs and an fp32 bias;
    the JAX kernel rounds p (and in the backward ds) to bf16 before its
    products where the plain version keeps fp32."""
    rng = np.random.RandomState(23)
    s = 32
    q, k, v, do = (rng.randn(B, H, s, DH).astype(np.float32)
                   for _ in range(4))
    q, k, v, do = (torch.from_numpy(a).bfloat16().float().numpy()
                   for a in (q, k, v, do))
    bias = _neg_inf_bias(rng, s, s, 3)
    scale = DH ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))

    def jf(qq, kk, vv):
        return jfa.flash_attention(
            qq, kk, vv, bias=jnp.asarray(bias), causal=True, scale=scale,
            block_q=16, block_k=16, block_q_bwd=16, block_k_bwd=16,
            interpret=True, autotune="off")

    jout, vjp = jax.vjp(jf, jq, jk, jv)
    jgrads = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]
    jout = np.asarray(jout.astype(jnp.float32))
    out, _, grads = _port_fwd_bwd(q, k, v, do, bias, True, None, scale,
                                  torch.bfloat16)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    assert np.all(np.abs(got - jout) <= np.abs(jout) * 2.0 ** -6 + 4e-3)
    for name, g, ref in zip(("dq", "dk", "dv"), grads, jgrads):
        g = g.float().numpy()
        floor = 0.02 * np.abs(ref).max()
        assert np.all(np.abs(g - ref) <= np.abs(ref) * 2.0 ** -6 + floor), \
            name


# ---------------------------------------------------------------------------
# routes: the gate, the refusals, the wrappers' C calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,d,split", [(512, 64, False), (608, 64, False),
                                       (640, 64, True), (544, 128, False),
                                       (576, 128, True)])
def test_gate_counts_the_bias_as_the_jax_gate_does(s, d, split):
    """A [block_q, block_k] fp32 block for the bias (the JAX
    ``_flash_bwd_impl`` gate, :775-784): bf16, non-causal (the additive
    future mask is a bias, not the causal flag)."""
    assert tfa.uses_split_backward(s, s, d, bias=True) == split
    assert not tfa.uses_split_backward(s, s, d)
    bq, bk = min(1024, s), min(1024, s)
    kv = s * d * 12 + 4 * bq * bk
    assert tfa.backward_kv_bytes(s, s, d, bias=True) == kv
    assert (kv > jfa._FUSED_BWD_MAX_KV_BYTES) == split


def test_bias_refusal_names_each_refused_route():
    """The wgmma route takes the bias in the single pass and the split
    alike: the route a bias shape takes (s640 d64 splits) is not refused.
    With dropout too it takes the bias where the backward splits (the gate
    counts 512-row blocks with both: s512 at d 64, s448 at d 128), and in
    the single pass (s448 at d 64); the FFMA route takes the bias alone
    and with dropout (its variants with both: fp32 with both splits from
    s452 at d 64); the frag.cuh kernels refuse the bias, with dropout or
    without."""
    bf, f32 = torch.bfloat16, torch.float32
    assert tfa.bias_refusal(bf, 64) is None
    assert tfa.bias_refusal(torch.float16, 128) is None
    q = torch.zeros(1, 1, 640, 64, dtype=bf)
    assert tfa._bwd_route(q, q, q, False, 0.0, bias=True) == (True, bf)
    for s, d in ((512, 64), (448, 128)):
        q = torch.zeros(1, 1, s, d, dtype=bf)
        assert tfa._bwd_route(q, q, q, False, 0.1, bias=True) == (True, bf)
    q = torch.zeros(1, 1, 448, 64, dtype=bf)
    assert tfa._bwd_route(q, q, q, False, 0.1, bias=True) == (False, bf)
    assert tfa.bias_refusal(f32, 64) is None
    assert tfa.bias_refusal(f32, 128) is None
    for s, split in ((384, False), (452, True)):
        q = torch.zeros(1, 1, s, 64)
        assert tfa._bwd_route(q, q, q, True, 0.1, bias=True) == (split, f32)
    q = torch.zeros(1, 1, 384, 256)
    with pytest.raises(NotImplementedError, match="bias.*frag.cuh"):
        tfa._bwd_route(q, q, q, True, 0.1, bias=True)
    assert "frag.cuh" in tfa.bias_refusal(bf, 32)
    assert "frag.cuh" in tfa.bias_refusal(f32, 256)


def _stub_library(monkeypatch):
    """The C calls the wrappers make, recorded instead of run (CPU tensors
    stand for the card's): ``(target, symbol, args)``. The flash launch
    counters get their values back at the test's end, so that no other
    test in the process sees these calls."""
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
    return calls


@pytest.mark.parametrize("shape,strides", [
    ((1, 1), (0, 0)), ((1, 3), (0, 16 * 24)), ((2, 1), (16 * 24, 0)),
    ((2, 3), (3 * 16 * 24, 16 * 24))])
def test_wrappers_pass_the_fp32_bias_with_its_broadcast_strides(
        monkeypatch, shape, strides):
    calls = _stub_library(monkeypatch)
    q = torch.zeros(2, 3, 16, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 3, 24, 64, dtype=torch.bfloat16)
    bias = torch.randn(*shape, 16, 24).bfloat16()
    f, g = tfa.flash_attention, tfa.flash_attention_bwd
    n0 = (f.bias_launches, g.bias_launches, f.dropout_launches)
    out, lse = tfa._flash_fwd_cuda(q, k, k, None, None, False, 0.125,
                                   block_rows=64, bias=bias)
    tfa._flash_bwd_cuda(q, k, k, out, lse, q, None, None, False, 0.125,
                        bias=bias)
    assert [c[1] for c in calls] == ["apex_flash_fwd_sm90",
                                     "apex_flash_bwd_sm90_fused"]
    for _, symbol, args in calls:
        ptr, sb, sh = args[-7:-4]
        assert (sb, sh) == strides and ptr is not None
        assert args[-4:-1] == (0, 0, 1.0)      # no dropout
    assert (f.bias_launches - n0[0], g.bias_launches - n0[1],
            f.dropout_launches - n0[2]) == (1, 1, 0)
    # without a bias: a null pointer, the kernels' code without it
    calls.clear()
    tfa._flash_fwd_cuda(q, k, k, None, None, False, 0.125, block_rows=64)
    assert calls[0][2][-7:-4] == (None, 0, 0)


def test_bias_operand_is_cast_without_expanding_a_broadcast_dim():
    base = torch.randn(1, 1, 8, 12, dtype=torch.float16)
    wide = base.expand(4, 5, 8, 12)               # strides 0: a broadcast
    t, sb, sh = tfa._bias_operand(wide, 4, 5, 8, 12, torch.device("cpu"))
    assert t.dtype == torch.float32 and tuple(t.shape) == (1, 1, 8, 12)
    assert (sb, sh) == (0, 0) and torch.equal(t, base.float())
    f32 = torch.randn(1, 5, 8, 12)
    t, sb, sh = tfa._bias_operand(f32, 4, 5, 8, 12, torch.device("cpu"))
    assert t.data_ptr() == f32.data_ptr() and (sb, sh) == (0, 96)
    odd = torch.randn(8 * 12 + 1)[1:].view(1, 1, 8, 12)     # 4-byte offset
    t, _, _ = tfa._bias_operand(odd, 1, 1, 8, 12, torch.device("cpu"))
    assert t.data_ptr() % 16 == 0 and torch.equal(t, odd)
    with pytest.raises(ValueError, match="broadcast"):
        tfa._bias_operand(torch.zeros(1, 1, 8, 11), 1, 1, 8, 12,
                          torch.device("cpu"))


@pytest.mark.parametrize("make,match", [
    # with dropout too, the frag.cuh kernels refuse the bias by name (the
    # FFMA route takes the two together: fp32 at d 64 and 128 no longer
    # refuses, so fp32 at kernel head dims 256 and 32 stands here)
    (lambda: (torch.zeros(1, 1, 448, 256),
              dict(dropout_rate=0.1, dropout_seed=1)), "frag.cuh"),
    (lambda: (torch.zeros(1, 1, 64, 32, dtype=torch.bfloat16),
              dict(dropout_rate=0.1, dropout_seed=1)), "frag.cuh"),
    (lambda: (torch.zeros(1, 1, 64, 32),
              dict(dropout_rate=0.2, dropout_seed=2)), "frag.cuh"),
    (lambda: (torch.zeros(1, 1, 64, 32, dtype=torch.bfloat16), {}),
     "frag.cuh"),
])
def test_cuda_bias_refusals_raise_before_any_launch(monkeypatch, make,
                                                    match):
    """Each refused route raises ``NotImplementedError`` naming it, before
    the forward, whenever grads are needed (the device check answers
    CUDA; the library is stubbed, and no call reaches it); with dropout
    too, the forward alone refuses as well."""
    calls = _stub_library(monkeypatch)
    monkeypatch.setattr(tfa, "check_device_type", lambda t, what: "cuda")
    q, kw = make()
    q.requires_grad_()
    bias = torch.zeros(1, 1, q.shape[2], q.shape[2])
    with pytest.raises(NotImplementedError, match=match) as err:
        tfa.flash_attention(q, q, q, bias=bias, **kw)
    assert "bias" in str(err.value) and calls == []
    if kw:      # the refused route names itself, without grads too
        with torch.no_grad(), pytest.raises(NotImplementedError,
                                            match="bias.*frag.cuh"):
            tfa.flash_attention(q, q, q, bias=bias, **kw)
        assert calls == []


def test_cuda_bias_with_dropout_at_s640_launches_the_split(monkeypatch):
    """s640 d64 with a bias and dropout, which the gate splits (it raised
    before the split took both): the forward, then the split's dq and
    dk/dv, each with the bias and the dropout."""
    calls = _stub_library(monkeypatch)
    monkeypatch.setattr(tfa, "check_device_type", lambda t, what: "cuda")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {
                            "multi_processor_count": 132})())
    q = torch.zeros(1, 1, 640, 64, dtype=torch.bfloat16, requires_grad=True)
    bias = torch.zeros(1, 1, 640, 640)
    out = tfa.flash_attention(q, q, q, bias=bias, dropout_rate=0.1,
                              dropout_seed=1)
    out.float().sum().backward()
    assert [c[1] for c in calls] == ["apex_flash_fwd_sm90",
                                     "apex_flash_bwd_sm90_dq",
                                     "apex_flash_bwd_sm90_dkdv"]
    for _, symbol, args in calls:
        assert args[-7].value is not None, symbol
        assert args[-4:-1] == tfa._dropout_args(0.1, 1), symbol


def test_cuda_bias_autograd_runs_the_bias_variants_and_a_zero_dbias(
        monkeypatch):
    """Through ``flash_attention`` (the device check answers CUDA, the
    library is stubbed): the forward and the single pass take the bias;
    its gradient is exactly zero in its own shape and dtype."""
    calls = _stub_library(monkeypatch)
    monkeypatch.setattr(tfa, "check_device_type", lambda t, what: "cuda")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {
                            "multi_processor_count": 132})())
    q = torch.zeros(2, 4, 32, 64, dtype=torch.bfloat16, requires_grad=True)
    bias = torch.zeros(1, 1, 32, 32, dtype=torch.bfloat16,
                       requires_grad=True)
    out = tfa.flash_attention(q, q, q, bias=bias)
    out.float().sum().backward()
    assert [c[1] for c in calls] == ["apex_flash_fwd_sm90",
                                     "apex_flash_bwd_sm90_fused"]
    assert bias.grad is not None and bias.grad.dtype == torch.bfloat16
    assert tuple(bias.grad.shape) == (1, 1, 32, 32)
    assert torch.count_nonzero(bias.grad).item() == 0


def test_cuda_split_bias_calls_dq_then_dkdv_with_the_bias(monkeypatch):
    """s640 d64 with a bias and grads (the gate splits it): through
    ``flash_attention`` (the device check answers CUDA, the library is
    stubbed) the forward's bias variant, then the split's dq and dk/dv,
    each handed the bias pointer and its two strides, and no dropout; the
    split's bias counters move, the single pass's not; dbias exactly zero
    in the bias's own shape and dtype."""
    calls = _stub_library(monkeypatch)
    monkeypatch.setattr(tfa, "check_device_type", lambda t, what: "cuda")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {
                            "multi_processor_count": 132})())
    b, h, s = 2, 3, 640
    q = torch.zeros(b, h, s, 64, dtype=torch.bfloat16, requires_grad=True)
    bias = torch.zeros(b, 1, s, s, dtype=torch.bfloat16, requires_grad=True)
    assert tfa.uses_split_backward(s, s, 64, bias=True)
    g = tfa.flash_attention_bwd
    n0 = (g.bias_launches, g.bias_dkdv_launches, g.bias_dq_launches,
          g.dropout_dkdv_launches, g.dropout_dq_launches)
    out = tfa.flash_attention(q, q, q, bias=bias)
    out.float().sum().backward()
    assert [c[1] for c in calls] == ["apex_flash_fwd_sm90",
                                     "apex_flash_bwd_sm90_dq",
                                     "apex_flash_bwd_sm90_dkdv"]
    ptrs = []
    for _, symbol, args in calls:
        ptr, sb, sh = args[-7:-4]
        ptrs.append(ptr.value)
        assert ptr.value is not None, symbol
        assert (sb, sh) == (s * s, 0), symbol
        assert args[-4:-1] == (0, 0, 1.0), symbol     # no dropout
    assert ptrs[1] == ptrs[2]      # one fp32 copy for the backward's pair
    moved = tuple(a - b_ for a, b_ in zip(
        (g.bias_launches, g.bias_dkdv_launches, g.bias_dq_launches,
         g.dropout_dkdv_launches, g.dropout_dq_launches), n0))
    assert moved == (0, 1, 1, 0, 0)
    assert bias.grad is not None and bias.grad.dtype == torch.bfloat16
    assert tuple(bias.grad.shape) == (b, 1, s, s)
    assert torch.count_nonzero(bias.grad).item() == 0
