"""The port's per-op cost probe (``apex_tpu_torch/scripts/vpu_probe.py``)
against the JAX script's Pallas kernel (``scripts/vpu_probe.py``'s
``make_kernel(op)``), run through ``pl.pallas_call(..., interpret=True)``
on one [1, 512, 512] block from a numpy seed.

Tolerances:

- ``max``, ``where``, ``iota_cmp_where``: bitwise (each step is one
  correctly rounded fp32 product and a compare);
- ``mul``: bitwise against numpy's op-by-op fp32 loop (64 rounded
  products, what the CUDA kernel and the Mosaic TPU kernel compute), and
  within 64 fp32 ulps of JAX's interpret mode: XLA's algebraic simplifier
  folds the 64 products by a constant into ONE product by the constant's
  64th power (folded in fp32), so the JAX reference rounds once where the
  chain rounds 64 times — at most half an ulp a step in the chain and in
  the folded constant (read 32);
- ``exp``, ``exp2``: within 2 fp32 ulps (two libraries' exponentials, each
  within an ulp; after the first step every value is within an ulp of 1).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from apex_tpu_torch.scripts import vpu_probe as vp

ROOT = Path(__file__).resolve().parent.parent


def _script():
    spec = importlib.util.spec_from_file_location(
        "vpu_probe_script", ROOT / "scripts" / "vpu_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _jax_probe(op):
    script = _script()
    x = np.random.RandomState(0).randn(1, vp.BQ, vp.BK).astype(np.float32)
    spec = pl.BlockSpec((1, vp.BQ, vp.BK), lambda i: (i, 0, 0))
    f = pl.pallas_call(
        script.make_kernel(op), grid=(1,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)
    return x, np.asarray(f(jnp.asarray(x)))


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def test_script_constants_match():
    script = _script()
    assert (script.REPS, script.BQ, script.BK) == (vp.REPS, vp.BQ, vp.BK)
    assert vp.OPS == ("mul", "max", "where", "iota_cmp_where", "exp",
                      "exp2")


@pytest.mark.parametrize("op", vp.OPS)
def test_plain_probe_matches_the_pallas_kernel(op):
    x, ref = _jax_probe(op)
    got = vp.vpu_probe_kernel(torch.from_numpy(x), op).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    if op in ("max", "where", "iota_cmp_where"):
        assert np.array_equal(got, ref), _ulps(got, ref)
    elif op == "mul":
        chain = x.copy()
        for _ in range(vp.REPS):
            chain = chain * np.float32(1.0000001)
        assert np.array_equal(got, chain)
        assert _ulps(got, ref) <= 64
    else:
        assert _ulps(got, ref) <= 2


def test_iota_mask_is_row_ge_col():
    x = -torch.ones(2, vp.BQ, vp.BK)
    got = vp.vpu_probe_reference(x, "iota_cmp_where")
    lower = torch.tril(torch.ones(vp.BQ, vp.BK, dtype=torch.bool))
    assert torch.equal(got[0] == -1.0, lower)
    assert torch.equal(got[1], got[0])


def test_cpu_wrapper_counts_no_launch_and_rejects_unknown_ops():
    before = vp.vpu_probe_kernel.launches
    vp.vpu_probe_kernel(torch.zeros(1, vp.BQ, vp.BK), "mul")
    assert vp.vpu_probe_kernel.launches == before
    with pytest.raises(ValueError, match="unknown op"):
        vp.vpu_probe_kernel(torch.zeros(1, vp.BQ, vp.BK), "tanh")
