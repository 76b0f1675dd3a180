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
