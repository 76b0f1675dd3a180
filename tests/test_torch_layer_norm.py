"""apex_tpu_torch LayerNorm forward against the JAX package.

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
