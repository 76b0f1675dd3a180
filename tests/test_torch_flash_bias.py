"""The port's flash attention under an additive bias against the JAX op.

The bias is an additive mask, non-differentiable by contract: the JAX
op's backward returns ``zeros_like(bias)`` for it (``_fa_bwd``). The
port's CPU route (``BiasedAttentionFunction``) must give the same: an
exactly zero bias gradient in the bias's own broadcast shape, and dq, dk
and dv within 1e-5 of ``jax.grad`` through
``apex_tpu.ops.flash_attention.flash_attention`` (Pallas interpret mode
on the CPU). Inputs from numpy seeds, fp32 on both sides.
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
