"""apex_tpu_torch's fused softmax cross entropy (``ops/fused_ce.py``)
against the JAX package.

Inputs are made with numpy from a seed and handed to both sides: n = 37
rows (not a multiple of the kernels' 16-row blocks), V = 1000 classes (the
ResNet-50 head; not a multiple of 128), fp32 and bf16 logits, label
smoothing 0 and 0.1, ``padding_idx`` None and 0 (five rows padded). The
loss is summed against a fixed probe, so each row's gradient has its own
``dloss``.

Tolerances and their reasons:

- the port's plain twin against the JAX twin (``softmax_cross_entropy_
  reference`` and ``jax.grad``): fp32 on both sides, exponentials and sums
  in other orders — the loss within 1e-6 relative, fp32 gradients within
  1e-6 of the largest; bf16 gradients (one rounding of an fp32 value on
  each side) within one bf16 ulp of the larger of the two;
- the same inputs against the JAX Pallas kernels in interpret mode
  (``block_t=16, block_v=128``, as ``tests/test_fused_kernels.py`` runs
  them), which combine per-block partials in another order: the loss within
  1e-5 relative, fp32 gradients within 1e-5 of the largest, bf16 gradients
  within one bf16 ulp plus 1e-6 of the largest — the kernel recomputes p
  from its own ``(m, l)``, and with smoothing ``p - s/V`` cancels near zero,
  where the JAX kernel and the JAX twin themselves land two ulps apart
  (1.2e-7 against a largest gradient of 0.9).
"""

import importlib

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jfc = importlib.import_module("apex_tpu.ops.fused_ce")
from apex_tpu_torch.ops import fused_ce as tfc

N, V = 37, 1000
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(dtype, padding_idx, seed=0, lead=(N,)):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*lead, V) * 2.0).astype(np.float32)
    if dtype == "bfloat16":
        logits = logits.astype(ml_dtypes.bfloat16).astype(np.float32)
    labels = rng.randint(1, V, lead).astype(np.int32)
    if padding_idx is not None:
        labels.reshape(-1)[:5] = padding_idx
    probe = np.cos(np.arange(int(np.prod(lead)), dtype=np.float32)).reshape(
        lead)
    return logits, labels, probe


def _jax_side(fn, logits, labels, probe, dtype, smoothing, padding_idx,
              **kw):
    lg = jnp.asarray(logits, _JAX[dtype])
    lab = jnp.asarray(labels)

    def total(x):
        return jnp.sum(fn(x, lab, smoothing, padding_idx, **kw) * probe)

    loss = fn(lg, lab, smoothing, padding_idx, **kw)
    grad = jax.grad(total)(lg)
    assert grad.dtype == lg.dtype
    return np.asarray(loss, np.float32), np.asarray(grad.astype(jnp.float32))


def _torch_side(logits, labels, probe, dtype, smoothing, padding_idx):
    x = torch.from_numpy(logits).to(_TORCH[dtype]).requires_grad_()
    before = (tfc.softmax_cross_entropy_with_smoothing.launches,
              tfc.softmax_cross_entropy_with_smoothing.bwd_launches)
    loss = tfc.softmax_cross_entropy_with_smoothing(
        x, torch.from_numpy(labels), smoothing, padding_idx)
    loss.backward(torch.from_numpy(probe))
    assert before == (tfc.softmax_cross_entropy_with_smoothing.launches,
                      tfc.softmax_cross_entropy_with_smoothing.bwd_launches)
    assert loss.dtype == torch.float32 and loss.shape == labels.shape
    assert x.grad.dtype == x.dtype
    return loss.detach().numpy(), x.grad.float().numpy()


def _check(got, ref, dtype, rel, bf16_floor=0.0):
    (gl, gg), (rl, rg) = got, ref
    np.testing.assert_allclose(gl, rl, rtol=rel, atol=0)
    if dtype == "float32":
        np.testing.assert_allclose(gg, rg, rtol=0,
                                   atol=rel * float(np.abs(rg).max()))
    else:
        # one bf16 ulp of the larger of the two values (the spacing at x
        # is at most |x| * 2^-7)
        ulp = np.maximum(np.abs(gg), np.abs(rg)) * 2.0 ** -7
        floor = bf16_floor * float(np.abs(rg).max()) + 1e-12
        assert np.all(np.abs(gg - rg) <= ulp + floor), \
            float(np.abs(gg - rg).max())


CASES = [(dt, s, p) for dt in ("float32", "bfloat16") for s in (0.0, 0.1)
         for p in (None, 0)]


@pytest.mark.parametrize("dtype,smoothing,padding_idx", CASES)
def test_twin_matches_jax_reference(dtype, smoothing, padding_idx):
    logits, labels, probe = _inputs(dtype, padding_idx)
    ref = _jax_side(jfc.softmax_cross_entropy_reference, logits, labels,
                    probe, dtype, smoothing, padding_idx)
    got = _torch_side(logits, labels, probe, dtype, smoothing, padding_idx)
    _check(got, ref, dtype, 1e-6)
    if padding_idx is not None:
        # padding rows: zero loss and zero gradient on both sides
        assert np.all(got[0][:5] == 0) and np.all(got[1][:5] == 0)
        assert np.all(ref[1][:5] == 0)


@pytest.mark.parametrize("dtype,smoothing,padding_idx", CASES)
def test_twin_matches_jax_pallas_interpret(dtype, smoothing, padding_idx):
    logits, labels, probe = _inputs(dtype, padding_idx, seed=1)
    ref = _jax_side(jfc.softmax_cross_entropy_with_smoothing, logits, labels,
                    probe, dtype, smoothing, padding_idx, block_t=16,
                    block_v=128, interpret=True)
    got = _torch_side(logits, labels, probe, dtype, smoothing, padding_idx)
    _check(got, ref, dtype, 1e-5, bf16_floor=1e-6)


def test_leading_dims_match_jax():
    """[2, 5, V] logits with [2, 5] labels: per-example losses shaped as the
    labels, as in the JAX package."""
    logits, labels, probe = _inputs("float32", 0, seed=2, lead=(2, 5))
    ref = _jax_side(jfc.softmax_cross_entropy_reference, logits, labels,
                    probe, "float32", 0.1, 0)
    got = _torch_side(logits, labels, probe, "float32", 0.1, 0)
    _check(got, ref, "float32", 1e-6)


def test_reexports_are_the_one_implementation():
    import apex_tpu_torch.contrib.xentropy as contrib_x
    import apex_tpu_torch.ops as ops
    import apex_tpu_torch.ops.xentropy as ops_x
    for name in ("softmax_cross_entropy_with_smoothing",
                 "SoftmaxCrossEntropyLoss"):
        assert getattr(ops_x, name) is getattr(tfc, name)
        assert getattr(contrib_x, name) is getattr(tfc, name)
    assert ops_x.softmax_cross_entropy_reference \
        is tfc.softmax_cross_entropy_reference
    assert ops.softmax_cross_entropy_with_smoothing \
        is tfc.softmax_cross_entropy_with_smoothing
    assert "fused_ce" in ops_x.__doc__ and "fused_ce" in contrib_x.__doc__


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("half_to_float", [False, True])
def test_loss_module_apply_dtype_contract(dtype, half_to_float):
    """``SoftmaxCrossEntropyLoss.apply``: the loss in the logits' dtype, or
    fp32 with ``half_to_float``; ``padding_idx`` defaults to 0."""
    logits, labels, _ = _inputs(dtype, 0, seed=3)
    want = jfc.SoftmaxCrossEntropyLoss.apply(
        jnp.asarray(logits, _JAX[dtype]), jnp.asarray(labels), 0.1,
        half_to_float=half_to_float)
    got = tfc.SoftmaxCrossEntropyLoss.apply(
        torch.from_numpy(logits).to(_TORCH[dtype]), torch.from_numpy(labels),
        0.1, half_to_float=half_to_float)
    assert str(got.dtype).split(".")[-1] == want.dtype.name
    assert np.all(got[:5].float().numpy() == 0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-6 if got.dtype == torch.float32
                               else 2.0 ** -7, atol=0)


@pytest.mark.parametrize("knob", ["block_t", "block_v", "interpret",
                                  "autotune"])
def test_tuner_knobs_raise(knob):
    x = torch.zeros(2, 8)
    y = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="tuner"):
        tfc.softmax_cross_entropy_with_smoothing(x, y, 0.1, **{knob: 16})


def test_foreign_device_raises():
    x = torch.zeros(2, 8, device="meta")
    y = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        tfc.softmax_cross_entropy_with_smoothing(x, y)
