"""The plans and sum orders of the fp8 dequant-matmul's prefill regime and of
the LayerNorm backward, against the JAX package.

The prefill regime (``csrc/fp8_matmul.cu``, m > 8) takes its row tile, its
K split across a thread-block cluster and each split's rows from
``fp8_matmul._prefill_plan(K, N)``; the LayerNorm backward
(``csrc/layer_norm_bwd.cu``) takes its kernel, its blocks and each block's
rows from ``layer_norm._ln_bwd_plan(n, h)``. Those plans fix every fp32 sum
the kernels take, so they are what keeps a rerun bitwise and (for the
matmul) a row's bits independent of the rows beside it.

The emulations below are plain PyTorch in fp32 that follow the kernels'
orders: the matmul's 16-deep k-steps within each split, the splits in rank
order, the divide by the scale last; the LayerNorm's dgamma/dbeta partials
row by row within a warp, the warps in order within a block, the blocks in
order. Inputs are made with numpy from a seed and handed to both sides; the
JAX side runs its plain version (``jax.vjp`` of it for the LayerNorm) and
its Pallas kernel in interpret mode. Tolerance: fp32 summation order only,
1e-5 of the largest value.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops import fp8_matmul as jmm
from apex_tpu.ops import layer_norm as jln
from apex_tpu_torch.ops import fp8_matmul as tmm
from apex_tpu_torch.ops import layer_norm as tln

E4M3 = torch.float8_e4m3fn
SERVE_LINEARS = {"qkv": (1024, 3072), "proj": (1024, 1024),
                 "fc1": (1024, 4096), "fc2": (4096, 1024)}


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# the prefill regime's plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,N", list(SERVE_LINEARS.values())
                         + [(1008, 1008), (1024, 2048), (128, 2560)])
def test_prefill_plan_depends_on_k_and_n_alone(K, N):
    """The row tile, the split count and each split's rows are the same for
    every m > 8 (the wrapper hands the kernel ``launch_plan``); every split
    is whole 64-row stages, at least two deep, and together they cover K;
    m <= 8 takes the decode regime."""
    bm, splits, kc = tmm._prefill_plan(K, N)
    assert (bm, splits) in ((128, 1), (64, 1), (64, 2))
    assert kc % 64 == 0 and splits * kc >= K and (splits - 1) * kc < K
    assert splits == 1 or kc >= 128
    for m in (9, 64, 512, 4096):
        assert tmm.launch_plan(m, K, N) == ("prefill", bm, splits, kc)
    for m in (1, 8):
        assert tmm.launch_plan(m, K, N)[0] == "decode"


def test_prefill_plan_at_the_serve_shapes():
    """At the engines' m512: qkv and fc1 fill the card with 128-row tiles
    (96 and 128 blocks); proj and fc2 (32 such tiles) take 64-row tiles
    and a cluster of two along K (128 blocks, one wave)."""
    assert tmm._prefill_plan(*SERVE_LINEARS["qkv"]) == (128, 1, 1024)
    assert tmm._prefill_plan(*SERVE_LINEARS["fc1"]) == (128, 1, 1024)
    assert tmm._prefill_plan(*SERVE_LINEARS["proj"]) == (64, 2, 512)
    assert tmm._prefill_plan(*SERVE_LINEARS["fc2"]) == (64, 2, 2048)
    for K, N in SERVE_LINEARS.values():
        bm, splits, _ = tmm._prefill_plan(K, N)
        assert 96 <= (512 // bm) * (N // 128) * splits <= 132


def test_e4m3_to_bf16_bit_placement_is_exact():
    """The kernel's conversion: sign to bit 15, the other seven bits 4 down
    (bf16's low exponent and top mantissa bits), times 2^120 — exact for
    every finite e4m3 code, subnormals included."""
    codes = np.arange(256, dtype=np.uint8)
    codes = codes[(codes & 0x7F) != 0x7F]                  # no NaN
    b = codes.astype(np.uint32)
    bits = ((b & 0x80) << 8) | ((b & 0x7F) << 4)
    as_bf16 = (bits << 16).view(np.float32)               # bf16 -> fp32
    want = codes.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    np.testing.assert_array_equal(as_bf16 * np.float32(2.0 ** 120), want)
    # and the port's own e4m3 -> fp32, which the plain version uses
    got = torch.from_numpy(codes.copy()).view(E4M3).float().numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the prefill regime's sum order
# ---------------------------------------------------------------------------

def _prefill_sum(x, q, scale):
    """The prefill regime's order: within each split, its 64-row stages'
    16-deep k-steps accumulated in fp32 in order; the splits' partials in
    rank order; the divide by the scale last."""
    K, N = q.shape
    _, splits, kc = tmm._prefill_plan(K, N)
    w = q.float()
    tot = None
    for r in range(splits):
        part = torch.zeros(x.shape[0], N, dtype=torch.float32)
        for k0 in range(r * kc, min(K, (r + 1) * kc), 16):
            part = part + x[:, k0:k0 + 16].float() @ w[k0:k0 + 16]
        tot = part if tot is None else tot + part
    return tot / scale


@pytest.mark.parametrize("m", [9, 64, 130])
def test_prefill_sum_order_matches_jax(m):
    K, N = 256, 384
    rng = np.random.RandomState(m)
    x = rng.randn(m, K).astype(np.float32)
    w = (rng.randn(K, N) * K ** -0.5).astype(np.float32)
    qj, sj = jmm.quantize_weight(jnp.asarray(w))
    tq = torch.from_numpy(np.array(qj).view(np.uint8)).view(E4M3)
    ts = torch.from_numpy(np.array(sj))
    assert tmm._prefill_plan(K, N)[1] == 2           # two splits
    got = _prefill_sum(torch.from_numpy(x), tq, ts).numpy()
    ref = np.asarray(jmm.fp8_dequant_matmul_reference(jnp.asarray(x), qj, sj))
    ker = np.asarray(jmm.fp8_dequant_matmul(
        jnp.asarray(x), qj, sj, block_k=128, block_n=128, interpret=True))
    plain = tmm.fp8_dequant_matmul_reference(torch.from_numpy(x), tq, ts)
    for want in (ref, ker, plain.numpy()):
        _close(got, want)


# ---------------------------------------------------------------------------
# the LayerNorm backward's plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h", [64, 1024, 1025, 16384])
@pytest.mark.parametrize("n", [0, 1, 7, 40, 8192, 8193])
def test_ln_bwd_plan(n, h):
    """A warp a row up to h 1024, a block a row past it; at most one block
    an SM; every block has rows (one block and no row at n = 0); the rows
    are covered once."""
    variant, blocks, rows = tln._ln_bwd_plan(n, h, 132)
    assert variant == ("warp_rows" if h <= 1024 else "block_rows")
    assert 1 <= blocks <= 132
    if n == 0:
        assert (blocks, rows) == (1, 0)
        return
    assert blocks * rows >= n > (blocks - 1) * rows
    unit = 8 if variant == "warp_rows" else 1
    assert blocks <= min(132, -(-n // unit))


def test_ln_bwd_plan_at_the_train_shape():
    """The GPT step's [8192, 1024]: 131 blocks of 63 rows, 7 or 8 a warp."""
    assert tln._ln_bwd_plan(8192, 1024, 132) == ("warp_rows", 131, 63)
    assert tln._ln_bwd_plan(8192, 4096, 132) == ("block_rows", 131, 63)


# ---------------------------------------------------------------------------
# the LayerNorm backward's sum order
# ---------------------------------------------------------------------------

def _ln_bwd_order(x, w, dy, eps=1e-5):
    """dx row by row (fp32 statistics, rounded nowhere), and dgamma/dbeta
    summed as the kernel sums them: over a warp's rows in order (warp w of
    a block takes its rows w, w + 8, ...; the block-rows kernel one
    partial over all its rows), the warps in order, the blocks in order."""
    n, h = x.shape
    variant, blocks, rows = tln._ln_bwd_plan(n, h, 132)
    x32, dy32, w32 = x.float(), dy.float(), w.float()
    mean = x32.sum(1, keepdim=True) / h
    xc = x32 - mean
    rstd = torch.rsqrt((xc * xc).sum(1, keepdim=True) / h + eps)
    xhat = xc * rstd
    dxhat = dy32 * w32
    s1 = dxhat.sum(1, keepdim=True)
    s2 = (dxhat * xhat).sum(1, keepdim=True)
    dx = (rstd / h) * (h * dxhat - s1 - xhat * s2)
    cw, cb = dy32 * xhat, dy32
    warps = 8 if variant == "warp_rows" else 1
    tot = None
    for b in range(blocks):
        lo, hi = b * rows, min(n, (b + 1) * rows)
        block = None
        for wp in range(warps):
            acc = torch.zeros(2, h, dtype=torch.float32)
            for r in range(lo + wp, hi, warps):
                acc = acc + torch.stack([cw[r], cb[r]])
            block = acc if block is None else block + acc
        tot = block if tot is None else tot + block
    return dx, tot[0], tot[1]


def _ln_inputs(n, h, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, h) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    dy = rng.randn(n, h).astype(np.float32)
    return x, w, b, dy


def _jax_vjp(x, w, b, dy, pallas):
    h = x.shape[-1]

    def fn(xx, ww, bb):
        if pallas:
            return jln.fused_layer_norm_affine(xx, ww, bb, (h,), 1e-5,
                                               jnp.float32, block_r=8,
                                               interpret=True)
        return jln.fused_layer_norm_affine_reference(xx, ww, bb, (h,), 1e-5,
                                                     jnp.float32)

    args = [jnp.asarray(a) for a in (x, w, b)]
    return [np.asarray(g) for g in jax.vjp(fn, *args)[1](jnp.asarray(dy))]


@pytest.mark.parametrize("h", [128, 1024])
@pytest.mark.parametrize("n", [1, 7, 40, 257])
def test_ln_bwd_order_matches_jax(n, h):
    x, w, b, dy = _ln_inputs(n, h, seed=n + h)
    got = _ln_bwd_order(*(torch.from_numpy(a) for a in (x, w, dy)))
    want = _jax_vjp(x, w, b, dy, pallas=False)
    plain = tln.layer_norm_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dy), (h,))
    for g, r, p in zip(got, want, plain):
        _close(g.numpy(), r)
        _close(g.numpy(), p.numpy())


@pytest.mark.parametrize("h", [128, 1024])
@pytest.mark.parametrize("n", [8, 40, 256])
def test_ln_bwd_order_matches_pallas_interpret(n, h):
    x, w, b, dy = _ln_inputs(n, h, seed=3 * n)
    got = _ln_bwd_order(*(torch.from_numpy(a) for a in (x, w, dy)))
    for g, r in zip(got, _jax_vjp(x, w, b, dy, pallas=True)):
        _close(g.numpy(), r)
