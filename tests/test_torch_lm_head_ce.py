"""apex_tpu_torch's fused LM-head cross entropy and vocab-parallel cross
entropy against the JAX package.

Inputs are made with numpy from a seed and handed to both sides. The JAX
fused loss runs its Pallas kernels in interpret mode (ragged token and
vocab counts across several blocks: n 40 at block_t 16, V 300 at block_v
128), as its own CPU tests run it; the port runs its plain versions on CPU
tensors. Gradients come from ``jax.grad`` (the custom VJP, i.e. the
backward kernel) and from torch autograd (the port's autograd function,
i.e. its plain backward), under random per-token upstream gradients.

Tolerances: fp32 losses and gradients within 1e-5 of the largest value
(fp32 on both sides, other summation order). bf16 inputs: losses within
1e-5 of the largest (both form fp32 logits from the same bf16 operands);
gradients within 2 bf16 ulps plus 1 % of the largest — the port rounds the
gradient tile g to bf16 before its products, as the JAX kernel does on the
TPU, while JAX's interpret mode keeps g in fp32 (it upcasts the operands),
and JAX adds bf16 per-vocab-block dx partials where the port sums fp32.
"""

import importlib

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.transformer.tensor_parallel import cross_entropy as jvce
from apex_tpu_torch.ops import lm_head_ce as tce
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy)

jce = importlib.import_module("apex_tpu.ops.lm_head_ce")

N, V, H = 40, 300, 64


def _inputs(seed, dtype):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H).astype(np.float32)
    e = (0.3 * rng.randn(V, H)).astype(np.float32)
    tgt = rng.randint(0, V, N).astype(np.int32)
    w = rng.rand(N).astype(np.float32)           # upstream dloss
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        e = e.astype(ml_dtypes.bfloat16).astype(np.float32)
    return x, e, tgt, w


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _torch(a, dtype):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _close(got, ref, dtype, rel_fp32=1e-5):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=rel_fp32 * scale, rtol=0)
    else:
        tol = np.abs(ref) * 2 * 2.0 ** -7 + 1e-2 * scale
        assert np.all(np.abs(got - ref) <= tol), float(np.abs(got - ref).max())


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_loss_and_grads_match_jax_interpret(dtype, smoothing):
    x, e, tgt, w = _inputs(0, dtype)

    def jloss(xx, ee):
        loss = jce.fused_lm_head_cross_entropy(
            xx, ee, jnp.asarray(tgt), smoothing, block_t=16, block_v=128,
            interpret=True, autotune="off")
        return jnp.sum(loss * jnp.asarray(w)), loss

    (_, jl), (jdx, jde) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(_jax(x, dtype),
                                                           _jax(e, dtype))
    tx = _torch(x, dtype).requires_grad_()
    te = _torch(e, dtype).requires_grad_()
    before = (tce.lm_head_ce_fwd.launches, tce.lm_head_ce_bwd.launches)
    tl = tce.fused_lm_head_cross_entropy(tx, te, torch.from_numpy(tgt),
                                         smoothing)
    (tl * torch.from_numpy(w)).sum().backward()
    assert before == (tce.lm_head_ce_fwd.launches,
                      tce.lm_head_ce_bwd.launches)       # CPU: no kernel
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (N,)
    assert tx.grad.dtype == tx.dtype and te.grad.dtype == te.dtype
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=1e-5 * float(np.abs(jl).max()), rtol=0)
    _close(tx.grad.float().numpy(), jdx, dtype)
    _close(te.grad.float().numpy(), jde, dtype)


def test_plain_backward_matches_autograd_of_the_plain_loss():
    """The explicit plain backward (``lm_head_ce_bwd_reference``) against
    autograd through ``lm_head_cross_entropy_reference``, fp32, with leading
    dims and label smoothing."""
    x, e, tgt, w = _inputs(1, "float32")
    tx = torch.from_numpy(x).reshape(4, 10, H).requires_grad_()
    te = torch.from_numpy(e).requires_grad_()
    tt = torch.from_numpy(tgt).reshape(4, 10).long()
    wt = torch.from_numpy(w).reshape(4, 10)
    got = tce.fused_lm_head_cross_entropy(tx, te, tt, 0.1)
    g = torch.autograd.grad((got * wt).sum(), (tx, te))
    ref = tce.lm_head_cross_entropy_reference(tx, te, tt, 0.1)
    r = torch.autograd.grad((ref * wt).sum(), (tx, te))
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-6)
    for a, b in zip(g, r):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vocab_parallel_ce_matches_jax(dtype, smoothing):
    rng = np.random.RandomState(2)
    logits = (3 * rng.randn(3, 7, 50)).astype(np.float32)
    if dtype == "bfloat16":
        logits = logits.astype(ml_dtypes.bfloat16).astype(np.float32)
    tgt = rng.randint(0, 50, (3, 7)).astype(np.int32)
    w = rng.rand(3, 7).astype(np.float32)

    def jloss(lg):
        loss = jvce.vocab_parallel_cross_entropy(lg, jnp.asarray(tgt),
                                                 smoothing)
        return jnp.sum(loss * jnp.asarray(w)), loss

    (_, jl), jg = jax.value_and_grad(jloss, has_aux=True)(
        _jax(logits, dtype))
    tl_in = _torch(logits, dtype).requires_grad_()
    tl = vocab_parallel_cross_entropy(tl_in, torch.from_numpy(tgt),
                                      smoothing)
    (tl * torch.from_numpy(w)).sum().backward()
    assert tl_in.grad.dtype == tl_in.dtype      # grads in the logits dtype
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=1e-5 * float(np.abs(jl).max()), rtol=0)
    got = tl_in.grad.float().numpy()
    ref = np.asarray(jg, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    else:
        # both round the same fp32 gradient to bf16: one ulp
        assert np.all(np.abs(got - ref) <= np.abs(ref) * 2.0 ** -7 + 1e-7)


def test_fused_loss_rejects_bad_smoothing_and_foreign_devices():
    x = torch.zeros(2, 8)
    e = torch.zeros(5, 8)
    t = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="label_smoothing"):
        tce.fused_lm_head_cross_entropy(x, e, t, 1.0)
    with pytest.raises(ValueError, match="not supported"):
        tce.fused_lm_head_cross_entropy(x.to("meta"), e.to("meta"),
                                        t.to("meta"))


# ---------------------------------------------------------------------------
# the wgmma backward's schedule (bf16 and fp16 on the card): tokens in
# chunks whose gradient workspace G [T_c, V] fits G_WORKSPACE_BYTES; per
# chunk g rounded once, dx_c = g E, and dE summed over the chunks in fp32
# ---------------------------------------------------------------------------

def test_bwd_chunk_planner_caps_the_workspace(monkeypatch):
    cap = tce.G_WORKSPACE_BYTES
    assert cap == 256 << 20
    # the GPT step: two chunks of 4096 tokens, 256 MiB of G each
    assert tce.bwd_chunk_tokens(8192, 32768) == 4096
    assert 4096 * 32768 * 2 <= cap
    # V 50257: rows of 50264 (16-byte aligned), 2560 tokens (a multiple of
    # 128) fit, 2688 would not
    assert tce.bwd_chunk_tokens(8192, 50257) == 2560
    assert 2560 * 50264 * 2 <= cap < 2688 * 50264 * 2
    # ragged n: no more than n rounded up to a tile
    assert tce.bwd_chunk_tokens(1000, 32768) == 1024
    assert tce.bwd_chunk_tokens(1, 1000) == 128
    # a lowered cap forces more chunks, never fewer than 128 tokens
    monkeypatch.setattr(tce, "G_WORKSPACE_BYTES", 300 * 1024 * 2)
    assert tce.bwd_chunk_tokens(1000, 1024) == 256
    assert -(-1000 // tce.bwd_chunk_tokens(1000, 1024)) == 4
    monkeypatch.setattr(tce, "G_WORKSPACE_BYTES", 1)
    assert tce.bwd_chunk_tokens(1000, 1024) == 128


def test_vocab_slices_fill_two_waves():
    # 64 token tiles x 4 slices = 256 blocks on 132 SMs
    assert tce.vocab_slices(8192, 32768, 132) == 4
    assert tce.vocab_slices(1000, 32768, 132) == 8      # capped at 8
    assert tce.vocab_slices(8192, 100, 132) == 1        # one vocab tile
    assert tce.vocab_slices(65536, 32768, 132) == 1


def _bwd_chunked(x2d, e, tgt, m, l, dloss, label_smoothing, chunk):
    """The wgmma backward's schedule (csrc/lm_head_ce_sm90.cu) in plain
    torch: per chunk of ``chunk`` tokens the fp32 logits, g rounded once
    to ``x2d.dtype``, ``dx_c = g E`` cast once, and ``dE`` summed over the
    chunks in fp32 and cast once to ``e.dtype``."""
    n, V = x2d.shape[0], e.shape[0]
    dx = torch.empty_like(x2d)
    de = torch.zeros(e.shape, dtype=torch.float32)
    cols = torch.arange(V)
    for r0 in range(0, n, chunk):
        xc = x2d[r0:r0 + chunk].float()
        s = xc @ e.float().t()
        p = torch.exp(s - m[r0:r0 + chunk, None]) / l[r0:r0 + chunk, None]
        hit = (tgt[r0:r0 + chunk].long()[:, None] == cols[None, :]).float()
        target = ((1.0 - label_smoothing) * hit + label_smoothing / V
                  if label_smoothing > 0.0 else hit)
        g = ((p - target) * dloss[r0:r0 + chunk].float()[:, None]).to(
            x2d.dtype).float()
        dx[r0:r0 + chunk] = (g @ e.float()).to(x2d.dtype)
        de += g.t() @ xc
    return dx, de.to(e.dtype)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_backward_matches_plain_and_jax(dtype, smoothing):
    """The three-product schedule in plain torch at three chunks (16, 16, 8
    of the 40 tokens) against the plain one-pass backward (the same g,
    rounded once: dx bitwise; dE within 1e-6 of the largest, plus one bf16
    ulp of it for bf16 — fp32 sums over chunks in another order, then one
    rounding) and against the JAX fused loss's gradient in interpret mode
    (the tolerances above)."""
    x, e, tgt, w = _inputs(3, dtype)
    tx, te = _torch(x, dtype), _torch(e, dtype)
    tt, tw = torch.from_numpy(tgt), torch.from_numpy(w)
    m, l, _, _ = tce.lm_head_ce_fwd_reference(tx, te, tt)
    dx, de = _bwd_chunked(tx, te, tt, m, l, tw, smoothing, chunk=16)
    rx, re = tce.lm_head_ce_bwd_reference(tx, te, tt, m, l, tw, smoothing)
    assert dx.dtype == tx.dtype and de.dtype == te.dtype
    assert torch.equal(dx, rx)
    np.testing.assert_allclose(de.float().numpy(), re.float().numpy(),
                               atol=1e-6 * float(re.float().abs().max())
                               + (2.0 ** -8 * float(re.float().abs().max())
                                  if dtype == "bfloat16" else 0.0), rtol=0)

    def jloss(xx, ee):
        loss = jce.fused_lm_head_cross_entropy(
            xx, ee, jnp.asarray(tgt), smoothing, block_t=16, block_v=128,
            interpret=True, autotune="off")
        return jnp.sum(loss * jnp.asarray(w))

    jdx, jde = jax.grad(jloss, argnums=(0, 1))(_jax(x, dtype), _jax(e, dtype))
    _close(dx.float().numpy(), jdx, dtype)
    _close(de.float().numpy(), jde, dtype)
