"""The additive bias in the flash backward's two-kernel split, against the
JAX package's split, on the CPU.

JAX is forced onto its split (``_FUSED_BWD_MAX_KV_BYTES`` = 0; nothing in
the JAX package changes), and a spy records that its ``_dkdv_kernel`` and
``_dq_kernel`` ran, in Pallas interpret mode as its own CPU tests run it.
The split's plain versions with ``bias=`` (``flash_bwd_dq_reference``: dq
and the delta it folds in from the forward's output;
``flash_bwd_dkdv_reference``: dk, dv from that delta), which the card
holds the split's bias variants against, give dq, dk and dv against
``jax.vjp`` through the JAX op, over the four broadcast shapes of the bias,
sq != sk, segment ids, causal and not, -inf entries and a row that is
-inf everywhere (its dq exactly 0, no NaN anywhere): fp32 within 1e-5 of
the largest gradient (fp32 math on both sides, other summation order);
bf16 operands within two bf16 ulps plus 2 % of the largest (the Pallas
kernels round p and ds to bf16 before their products, the plain versions
keep fp32). A tiny ``SelfMultiheadAttn`` under an additive [sq, sk] mask,
JAX's on its forced split, gives the port's module's output and gradients
within 1e-5 of the largest value.
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.contrib import multihead_attn as jmha
from apex_tpu_torch.contrib import multihead_attn as tmha
from apex_tpu_torch.ops import flash_attention as tfa

# ``apex_tpu.ops`` re-exports a function of the same name as the module
jfa = importlib.import_module("apex_tpu.ops.flash_attention")

B, H, DH = 2, 2, 16


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


@pytest.mark.parametrize("bias_shape,causal,sq,sk,seg,neg_inf,dead,dtype", [
    ((1, 1), False, 32, 32, False, False, None, "float32"),
    ((1, H), True, 32, 32, False, False, None, "float32"),
    ((B, 1), False, 24, 40, False, False, None, "float32"),   # sq != sk
    ((B, H), True, 40, 24, False, False, None, "float32"),    # sq > sk
    ((1, 1), True, 32, 32, True, False, None, "float32"),     # segments
    ((B, H), False, 32, 32, True, True, None, "float32"),
    ((1, H), False, 32, 32, False, True, 5, "float32"),       # a dead row
    ((1, H), True, 32, 32, False, True, 5, "float32"),
    ((B, H), True, 32, 32, False, True, 3, "bfloat16"),
])
def test_plain_split_with_bias_matches_jax_split(bias_shape, causal, sq, sk,
                                                 seg, neg_inf, dead, dtype,
                                                 monkeypatch):
    rng = np.random.RandomState(20)
    q, do = (rng.randn(B, H, sq, DH).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, sk, DH).astype(np.float32) for _ in range(2))
    bias = _bias(rng, bias_shape, sq, sk, neg_inf, dead)
    scale = DH ** -0.5
    kw, tkw = dict(causal=causal), dict(causal=causal)
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
    ran = _force_jax_split(monkeypatch)

    def jf(qq, kk, vv):
        return jfa.flash_attention(qq, kk, vv, bias=jnp.asarray(bias),
                                   scale=scale, block_q=16, block_k=16,
                                   block_q_bwd=16, block_k_bwd=16,
                                   interpret=True, autotune="off", **kw)

    _, vjp = jax.vjp(jf, *jarr[:3])
    jgrads = [np.asarray(g, np.float32) for g in vjp(jarr[3])]
    assert set(ran) == {"_dkdv_kernel", "_dq_kernel"}

    tq, tk, tv, tdo = tarr
    tbias = torch.from_numpy(bias)
    out, lse = tfa.flash_attention_reference(tq, tk, tv, scale=scale,
                                             bias=tbias, **tkw)
    dq, delta = tfa.flash_bwd_dq_reference(tq, tk, tv, out, lse, tdo,
                                           scale=scale, bias=tbias, **tkw)
    dk, dv = tfa.flash_bwd_dkdv_reference(tq, tk, tv, lse, delta, tdo,
                                          scale=scale, bias=tbias, **tkw)
    want = (tdo.float() * out.float()).sum(-1)
    np.testing.assert_allclose(delta.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), jgrads):
        assert got.dtype == tq.dtype and bool(torch.isfinite(got).all())
        g = got.float().numpy()
        big = float(np.abs(ref).max())
        if dtype == "float32":
            np.testing.assert_allclose(g, ref, atol=1e-5 * max(1.0, big),
                                       rtol=0, err_msg=name)
        else:
            tol = np.abs(ref) * 2 * 2.0 ** -7 + 2e-2 * big
            assert np.all(np.abs(g - ref) <= tol), \
                (name, float(np.abs(g - ref).max()))
    if dead is not None:
        assert bool((lse[:, :, dead] == -1e30).all())
        assert torch.count_nonzero(dq[:, :, dead]).item() == 0
        np.testing.assert_array_equal(jgrads[0][:, :, dead], 0.0)
    # the bias moved every gradient: not the split without it
    out0, lse0 = tfa.flash_attention_reference(tq, tk, tv, scale=scale,
                                               **tkw)
    dq0, delta0 = tfa.flash_bwd_dq_reference(tq, tk, tv, out0, lse0, tdo,
                                             scale=scale, **tkw)
    dk0, dv0 = tfa.flash_bwd_dkdv_reference(tq, tk, tv, lse0, delta0, tdo,
                                            scale=scale, **tkw)
    for got, plain in zip((dq, dk, dv), (dq0, dk0, dv0)):
        assert not torch.allclose(got.float(), plain.float())


@pytest.mark.parametrize("causal,seg", [(False, False), (True, True)])
def test_split_references_with_bias_compose_to_the_plain_backward(causal,
                                                                  seg):
    """dq with its folded delta, then dk/dv on that delta, is the plain
    backward with the same bias (the same operations; bitwise on the
    CPU)."""
    g = torch.Generator().manual_seed(20)
    b, h, sq, sk, d = 2, 3, 40, 56, 16
    q, do = (torch.randn(b, h, sq, d, generator=g) for _ in range(2))
    k, v = (torch.randn(b, h, sk, d, generator=g) for _ in range(2))
    bias = torch.randn(b, 1, sq, sk, generator=g)
    bias[torch.rand(bias.shape, generator=g) < 0.2] = float("-inf")
    bias[..., -1] = 0.0
    sid = None
    if seg:
        sid = torch.zeros(b, sq, dtype=torch.int32)
        sid[1, sq - 6:] = -1
    kw = dict(causal=causal, segment_ids_q=sid,
              segment_ids_kv=None if sid is None else torch.zeros(
                  b, sk, dtype=torch.int32), bias=bias)
    out, lse = tfa.flash_attention_reference(q, k, v, **kw)
    dq, delta = tfa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw)
    dk, dv = tfa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do, **kw)
    ref = tfa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    for got, r in zip((dq, dk, dv), ref):
        assert torch.equal(got, r)


E, HEADS, S = 32, 4, 32


def test_self_multihead_attn_with_a_mask_matches_jax_on_its_split(
        monkeypatch):
    """``SelfMultiheadAttn(use_bias=True, include_norm_add=True)``, fast
    impl, under fairseq's additive future mask [sq, sk] with key padding:
    JAX's module on its forced split (interpret mode), the port's on its
    plain versions; output, input and every parameter's gradient within
    1e-5 of the largest value."""
    rng = np.random.RandomState(20)
    x = rng.randn(S, B, E).astype(np.float32)
    dout = rng.randn(S, B, E).astype(np.float32)
    mask = np.triu(np.full((S, S), -np.inf, np.float32), 1)
    pad = np.zeros((B, S), bool)
    pad[1, S - 5:] = True
    opts = dict(use_bias=True, include_norm_add=True, impl="fast")
    ran = _force_jax_split(monkeypatch)
    jmod = jmha.SelfMultiheadAttn(E, HEADS, **opts)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x),
                       is_training=False)["params"]

    def jf(p, xx):
        return jmod.apply({"params": p}, xx, is_training=False,
                          attn_mask=jnp.asarray(mask),
                          key_padding_mask=jnp.asarray(pad))

    jout, vjp = jax.vjp(jf, params, jnp.asarray(x))
    jgrads = vjp(jnp.asarray(dout))
    assert set(ran) == {"_dkdv_kernel", "_dq_kernel"}
    flat = {k: np.asarray(v) for k, v in jax.device_get(params).items()}
    tmod = tmha.SelfMultiheadAttn.params_from_jax(E, HEADS, flat,
                                                  device="cpu", **opts)
    tx = torch.from_numpy(x).requires_grad_()
    out = tmod(tx, is_training=False, attn_mask=torch.from_numpy(mask),
               key_padding_mask=torch.from_numpy(pad))
    out.backward(torch.from_numpy(dout))

    def close(got, ref, what):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.detach().numpy(), ref,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   rtol=0, err_msg=what)

    close(out, jout, "out")
    close(tx.grad, jgrads[1], "input")
    for name, p in tmod.named_parameters():
        close(p.grad, jgrads[0][name], name)
