"""apex_tpu_torch's fp8 codec, fp8 dequant-matmul and fp8-KV paged decode
against the JAX package.

Inputs are made with numpy from a seed and handed to both sides; fp8
values cross as their bytes (uint8 views: ``ml_dtypes`` on the JAX side,
``torch.float8_e4m3fn``/``float8_e5m2`` on the port's). Tolerances: the
codec (``compute_scale``, ``quantize``, ``quantize_weight``) is bitwise
equal; the dequant-matmul's plain version within 1e-5 relative of the JAX
reference and of the JAX Pallas kernel in interpret mode (fp32 sums in
another order); the fp8 paged decode's plain version within 1e-5 of the
JAX reference and of the Pallas kernel in interpret mode.
"""

import importlib

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.amp import fp8 as jfp8
from apex_tpu.ops import fp8_matmul as jmm
from apex_tpu_torch._compat import as_torch_dtype
from apex_tpu_torch.amp import fp8 as tfp8
from apex_tpu_torch.ops import fp8_matmul as tmm

# ``apex_tpu.ops`` re-exports a function of the same name as the module
jfa = importlib.import_module("apex_tpu.ops.flash_attention")
from apex_tpu_torch.ops import flash_attention as tfa  # noqa: E402

WIRE = {"e4m3": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
        "e5m2": (ml_dtypes.float8_e5m2, torch.float8_e5m2)}


def _bytes_j(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


def _bytes_t(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


def _to_torch_fp8(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """An ml_dtypes fp8 array as a torch fp8 tensor, byte for byte."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.uint8).copy()
                            ).view(dtype)


def _spread(rng, shape):
    """Values across many binades: subnormals of e4m3, normals, values
    past both formats' maxima, exact zeros and both signs."""
    x = rng.randn(*shape) * np.exp2(rng.randint(-14, 18, shape))
    x[rng.rand(*shape) < 0.02] = 0.0
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def test_constants_match_jax():
    assert tfp8.E4M3_MAX == jfp8.E4M3_MAX == torch.finfo(tfp8.E4M3).max
    assert tfp8.E5M2_MAX == jfp8.E5M2_MAX == torch.finfo(tfp8.E5M2).max
    for name, (jd, td) in WIRE.items():
        assert tfp8.fp8_max(td) == jfp8.fp8_max(jd), name
        assert as_torch_dtype(jd) is td
    with pytest.raises(ValueError, match="not an fp8"):
        tfp8.fp8_max(torch.bfloat16)


@pytest.mark.parametrize("margin", [0.0, 2.0])
def test_compute_scale_matches_jax_bitwise(margin):
    amax = np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, 1e-30,
                       3.5e-3, 0.25, 1.0, 7.0, 448.0, 1e30, 3e38, -2.0],
                      np.float32)
    for fmt in (jfp8.E4M3_MAX, jfp8.E5M2_MAX):
        want = np.asarray(jfp8.compute_scale(jnp.asarray(amax), fmt, margin))
        got = tfp8.compute_scale(torch.from_numpy(amax), fmt, margin)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
        # the guard: every scale finite, and positive unless amax * 2**margin
        # overflows (then the quotient is 0 on both sides)
        assert bool(torch.isfinite(got).all())
        fits = np.abs(amax) * 2.0 ** margin < np.finfo(np.float32).max
        assert bool((got[torch.from_numpy(fits)] > 0).all())


@pytest.mark.parametrize("wire", ["e4m3", "e5m2"])
@pytest.mark.parametrize("scale", [1.0, 0.37, 12.5, 3e-3])
def test_quantize_matches_jax_bitwise(wire, scale):
    jd, td = WIRE[wire]
    x = _spread(np.random.RandomState(0), (64, 257))
    want = jfp8.quantize(jnp.asarray(x), jnp.float32(scale), jd)
    got = tfp8.quantize(torch.from_numpy(x), torch.tensor(scale), td)
    assert got.dtype == td
    np.testing.assert_array_equal(_bytes_t(got), _bytes_j(want))
    # saturating: no NaN out of finite inputs
    assert not bool(torch.isnan(got.float()).any())


def test_quantize_bf16_input_matches_jax_bitwise():
    x = _spread(np.random.RandomState(1), (33, 70))
    xb = x.astype(ml_dtypes.bfloat16)
    want = jfp8.quantize(jnp.asarray(xb), jnp.float32(0.8), jfp8.E4M3)
    got = tfp8.quantize(torch.from_numpy(x).to(torch.bfloat16),
                        torch.tensor(0.8), tfp8.E4M3)
    np.testing.assert_array_equal(_bytes_t(got), _bytes_j(want))


def test_dequantize_and_amax_match_jax():
    x = _spread(np.random.RandomState(2), (16, 40))
    q = np.asarray(jfp8.quantize(jnp.asarray(x), jnp.float32(0.5),
                                 jfp8.E4M3))
    tq = _to_torch_fp8(q, tfp8.E4M3)
    want = np.asarray(jfp8.dequantize(jnp.asarray(q), jnp.float32(0.5)))
    got = tfp8.dequantize(tq, torch.tensor(0.5))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tfp8.dequantize(tq, 0.5, torch.bfloat16).dtype == torch.bfloat16
    assert float(tfp8.amax(torch.from_numpy(x))) == \
        float(jfp8.amax(jnp.asarray(x)))


@pytest.mark.parametrize("margin", [0.0, 2.0])
def test_quantize_weight_matches_jax_bitwise(margin):
    w = (np.random.RandomState(3).randn(96, 160) * 0.05).astype(np.float32)
    jq, js = jmm.quantize_weight(jnp.asarray(w), margin=margin)
    tq, ts = tmm.quantize_weight(torch.from_numpy(w), margin=margin)
    assert tq.dtype == torch.float8_e4m3fn and ts.shape == ()
    np.testing.assert_array_equal(_bytes_t(tq), _bytes_j(jq))
    assert ts.numpy().view(np.uint32) == np.asarray(js).view(np.uint32)


# ---------------------------------------------------------------------------
# fp8 dequant-matmul
# ---------------------------------------------------------------------------

def _mk_xq(lead, K, N, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, K).astype(np.float32)
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    q, scale = jmm.quantize_weight(jnp.asarray(w))
    return x, np.asarray(q), np.asarray(scale)


@pytest.mark.parametrize("lead,K,N", [((8,), 64, 192), ((1, 16), 64, 256),
                                      ((5,), 256, 64), ((2, 3), 48, 32)])
def test_dequant_matmul_reference_matches_jax(lead, K, N):
    x, q, scale = _mk_xq(lead, K, N, seed=K + N)
    want = np.asarray(jmm.fp8_dequant_matmul_reference(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale)))
    tq = _to_torch_fp8(q, tfp8.E4M3)
    got = tmm.fp8_dequant_matmul_reference(torch.from_numpy(x), tq,
                                           torch.from_numpy(scale))
    assert got.shape == lead + (N,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m", [8, 40])
def test_dequant_matmul_matches_jax_pallas_interpret(m):
    """The port's entry on CPU tensors against the JAX Pallas kernel in
    interpret mode (explicit 128 blocks, as the JAX tests pin them)."""
    x, q, scale = _mk_xq((m,), 256, 384, seed=m)
    want = np.asarray(jmm.fp8_dequant_matmul(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale), block_k=128,
        block_n=128, interpret=True))
    before = tmm.fp8_dequant_matmul.launches
    got = tmm.fp8_dequant_matmul(torch.from_numpy(x),
                                 _to_torch_fp8(q, tfp8.E4M3),
                                 torch.from_numpy(scale))
    assert tmm.fp8_dequant_matmul.launches == before     # no kernel on CPU
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_dequant_matmul_bf16_out_and_guards():
    x, q, scale = _mk_xq((4,), 64, 32, seed=5)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tq = _to_torch_fp8(q, tfp8.E4M3)
    ts = torch.from_numpy(scale)
    y = tmm.fp8_dequant_matmul(tx, tq, ts)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, tmm.fp8_dequant_matmul_reference(tx, tq, ts))
    assert tmm.fp8_dequant_matmul(tx, tq, ts, torch.float32).dtype == \
        torch.float32
    with pytest.raises(ValueError, match="e4m3"):
        tmm.fp8_dequant_matmul(tx, tq.float(), ts)
    with pytest.raises(ValueError, match="e4m3"):
        tmm.fp8_dequant_matmul(tx, tq.view(torch.uint8).view(
            torch.float8_e5m2), ts)
    with pytest.raises(ValueError, match="contraction"):
        tmm.fp8_dequant_matmul(tx[:, :32], tq, ts)


@pytest.mark.parametrize("K,N", [(1024, 3072), (1024, 1024), (1024, 4096),
                                 (4096, 1024), (64, 192), (256, 64),
                                 (48, 16), (100000, 16)])
def test_dequant_matmul_k_split_depends_on_k_and_n_only(K, N):
    """The decode regime's K split: one thread-block cluster of 1, 2, 4 or
    8 splits a column tile, the fewest that give about one block an SM
    (unless K runs out first), each of whole 64-row stages and at least
    two of them unless K is smaller, covering K with no split idle — and a
    function of (K, N) alone, so a row's sum order never depends on the
    batch it comes in."""
    splits, kc = tmm._splits(K, N)
    tiles = -(-N // tmm._TILE_N)
    assert splits in (1, 2, 4, 8) and splits <= tmm._MAX_SPLITS
    assert kc % tmm._STAGE_K == 0 and splits * kc >= K
    assert (splits - 1) * kc < K                 # the last split has rows
    assert kc >= tmm._MIN_SPLIT_K or splits == 1
    if splits < tmm._MAX_SPLITS and 2 * splits * tmm._MIN_SPLIT_K <= K:
        assert tiles * splits >= tmm._FILL
    assert splits == 1 or tiles * (splits // 2) < tmm._FILL
    assert tmm._splits(K, N) == (splits, kc)


# ---------------------------------------------------------------------------
# fp8-KV paged decode (the plain version of the kernel's fp8 variant)
# ---------------------------------------------------------------------------

def _fp8_pool(rng, kv, num_pages, page, d):
    """e4m3 pages quantized per (head, page) with the codec, and their
    scales, as the cache writes them."""
    x = rng.randn(kv, num_pages, page, d).astype(np.float32)
    amax = np.abs(x).max(axis=(2, 3))
    sc = np.asarray(jfp8.compute_scale(jnp.asarray(amax), jfp8.E4M3_MAX, 2.0))
    q = np.asarray(jfp8.quantize(jnp.asarray(x), jnp.asarray(sc)[..., None,
                                                                  None],
                                 jfp8.E4M3))
    return q, sc


@pytest.mark.parametrize("b,kv,g,page,m,seq_lens", [
    (3, 2, 1, 8, 4, [13, 0, 32]),
    (2, 1, 4, 16, 2, [1, 20]),
])
def test_fp8_paged_decode_matches_jax(b, kv, g, page, m, seq_lens):
    rng = np.random.RandomState(sum(seq_lens))
    d, num_pages = 16, 1 + b * m
    q = rng.randn(b, kv, g, d).astype(np.float32)
    kq, ks = _fp8_pool(rng, kv, num_pages, page, d)
    vq, vs = _fp8_pool(rng, kv, num_pages, page, d)
    bt = rng.permutation(np.arange(1, num_pages))[:b * m].reshape(b, m)
    bt = bt.astype(np.int32)
    sl = np.asarray(seq_lens, np.int32)
    j_args = (jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
              jnp.asarray(bt), jnp.asarray(sl))
    j_scales = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    want_ref = np.asarray(jfa.paged_attention_reference(*j_args, **j_scales))
    want_kernel = np.asarray(jfa.paged_decode_attention(
        *j_args, interpret=True, **j_scales))
    before = tfa.paged_decode_attention.fp8_launches
    got = tfa.paged_decode_attention(
        torch.from_numpy(q), _to_torch_fp8(kq, tfp8.E4M3),
        _to_torch_fp8(vq, tfp8.E4M3), torch.from_numpy(bt),
        torch.from_numpy(sl), k_scales=torch.from_numpy(ks),
        v_scales=torch.from_numpy(vs))
    assert tfa.paged_decode_attention.fp8_launches == before
    np.testing.assert_allclose(got.numpy(), want_ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=1e-5, rtol=0)
    for i, n in enumerate(seq_lens):
        if n == 0:
            assert float(got[i].abs().max()) == 0.0
    with pytest.raises(ValueError, match="BOTH"):
        tfa.paged_decode_attention(
            torch.from_numpy(q), _to_torch_fp8(kq, tfp8.E4M3),
            _to_torch_fp8(vq, tfp8.E4M3), torch.from_numpy(bt),
            torch.from_numpy(sl), k_scales=torch.from_numpy(ks))
