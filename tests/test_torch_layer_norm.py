"""apex_tpu_torch LayerNorm forward and backward against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX reference
(``fused_layer_norm_affine_reference``), the JAX Pallas kernel in interpret
mode (``block_r=8``) and the port's wrapper on CPU tensors (its plain
version). Tolerances: fp32 outputs within 1e-5 absolute (fp32 statistics on
both sides, summed in another order); bf16 outputs within one bf16 ulp
(both round an fp32 result to bf16).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.normalization import FusedLayerNorm as JFusedLayerNorm
from apex_tpu.ops import layer_norm as jln
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops import layer_norm as tln

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    return x, w, b


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _assert_close(got, ref, dtype):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    else:
        assert np.all(np.abs(got - ref) <= np.abs(ref) * 2.0 ** -7 + 1e-6)


def _jax_x(x, dtype):
    return jnp.asarray(x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16"
                       else x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 128), (3, 5, 256)])
def test_plain_ln_matches_jax_reference_and_pallas(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, b = _inputs(shape)
    h = shape[-1]
    jx = _jax_x(x, dtype)
    ref = jln.fused_layer_norm_affine_reference(jx, jnp.asarray(w),
                                                jnp.asarray(b), (h,), 1e-5,
                                                jdt)
    pallas = jln.fused_layer_norm_affine(jx, jnp.asarray(w), jnp.asarray(b),
                                         (h,), 1e-5, jdt, block_r=8,
                                         interpret=True)
    before = tln.fused_layer_norm_affine.launches
    got = tln.fused_layer_norm_affine(torch.from_numpy(x).to(tdt),
                                      torch.from_numpy(w),
                                      torch.from_numpy(b), (h,), 1e-5, tdt)
    assert got.dtype == tdt and tuple(got.shape) == shape
    assert tln.fused_layer_norm_affine.launches == before   # CPU: no kernel
    _assert_close(_to_numpy(got), ref, dtype)
    _assert_close(_to_numpy(got), pallas, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_layer_norm_module_matches_flax(dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, b = _inputs((4, 7, 128), seed=1)
    jy = JFusedLayerNorm(normalized_shape=128, dtype=jdt).apply(
        {"params": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}},
        _jax_x(x, dtype))
    mod = FusedLayerNorm(128, dtype=tdt, device="cpu")
    assert mod.weight.dtype == torch.float32      # fp32 params
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w))
        mod.bias.copy_(torch.from_numpy(b))
        ty = mod(torch.from_numpy(x).to(tdt))
    assert ty.dtype == tdt
    _assert_close(_to_numpy(ty), jy, dtype)


def test_ln_rejects_shape_mismatch_and_foreign_devices():
    x, w, b = _inputs((4, 128))
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    with pytest.raises(ValueError, match="does not match"):
        tln.fused_layer_norm_affine(tx, tw, tb, (64,))
    with pytest.raises(ValueError, match="not supported"):
        tln.fused_layer_norm_affine(tx.to("meta"), tw.to("meta"),
                                    tb.to("meta"), (128,))


# ---------------------------------------------------------------------------
# the backward: the port's plain backward (``layer_norm_bwd_reference``,
# reached through autograd) against the JAX custom VJP of the reference
# (``_ln_bwd_affine``) and of the Pallas kernel pair in interpret mode.
# fp32 within 1e-5 of the largest gradient (fp32 math, other summation
# order); bf16 activations or params within one ulp of their dtype plus
# 1e-5 of the largest (fp32 math on both sides, rounded once at the end).
# ---------------------------------------------------------------------------

def _close_grad(got, ref, dtype):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    tol = np.abs(ref) * ulp + 1e-5 * float(np.abs(ref).max()) + 1e-7
    assert np.all(np.abs(got - ref) <= tol), float(np.abs(got - ref).max())


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 128), (3, 5, 256)])
def test_plain_ln_bwd_matches_jax_vjp_and_pallas(shape, dtype, p_dtype):
    jdt, tdt = DTYPES[dtype]
    jpdt, tpdt = DTYPES[p_dtype]
    x, w, b = _inputs(shape, seed=2)
    dy = np.random.RandomState(3).randn(*shape).astype(np.float32)
    h = shape[-1]
    jx, jdy = _jax_x(x, dtype), _jax_x(dy, dtype)
    jw, jb = jnp.asarray(w).astype(jpdt), jnp.asarray(b).astype(jpdt)

    def ref_fn(xx, ww, bb):
        return jln.fused_layer_norm_affine_reference(xx, ww, bb, (h,), 1e-5,
                                                     jdt)

    def pallas_fn(xx, ww, bb):
        return jln.fused_layer_norm_affine(xx, ww, bb, (h,), 1e-5, jdt,
                                           block_r=8, interpret=True)

    ref = jax.vjp(ref_fn, jx, jw, jb)[1](jdy)
    pallas = jax.vjp(pallas_fn, jx, jw, jb)[1](jdy)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tpdt).requires_grad_()
    tb = torch.from_numpy(b).to(tpdt).requires_grad_()
    before = tln.layer_norm_bwd.launches
    y = tln.fused_layer_norm_affine(tx, tw, tb, (h,), 1e-5, tdt)
    y.backward(torch.from_numpy(dy).to(tdt))
    assert tln.layer_norm_bwd.launches == before        # CPU: no kernel
    got = (tx.grad, tw.grad, tb.grad)
    for g, want_dtype, r, pr, kind in zip(got, (tdt, tpdt, tpdt), ref, pallas,
                                          (dtype, p_dtype, p_dtype)):
        assert g.dtype == want_dtype
        _close_grad(_to_numpy(g), r, kind)
        _close_grad(_to_numpy(g), pr, kind)


def test_fused_layer_norm_module_takes_bf16_params_and_trains():
    """O2 casts LayerNorm params to bf16: the module runs and its params
    get gradients in their own dtype."""
    mod = FusedLayerNorm(64, dtype=torch.bfloat16, device="cpu")
    mod.to(torch.bfloat16)
    x = torch.randn(4, 64, dtype=torch.bfloat16, requires_grad=True)
    mod(x).float().square().sum().backward()
    assert mod.weight.grad.dtype == torch.bfloat16
    assert x.grad.shape == x.shape
