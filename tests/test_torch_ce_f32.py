"""The fp32 (O0) route of the fused LM-head CE: its shape plan and its
schedule in plain torch, against the plain versions and the JAX package.

The route's kernels (``csrc/lm_head_ce.cu`` on the FFMA core of
``csrc/simt_f32.cuh``) run only on the card; what they take from Python is
tested here at the shapes ``chip_smoke.py`` runs and at ragged ones:

- ``f32_hidden``: h rounded up to 4 (16-byte rows);
- ``f32_vocab_slices``: the forward's vocabulary slices, about two blocks
  an SM; the kernel walks ``ceil(tiles / slices)`` 128-row tiles a slice,
  so a trailing slice may hold none, and ``combine_partials`` must add
  nothing from it (m = -1e30, l = 0);
- ``f32_chunk_tokens``: the backward's token chunks, G and G^T within
  ``F32_WORKSPACE_BYTES``.

Tolerance: fp32 on both sides, sums of up to ~1000 terms in another
order: 1e-5 of the largest value, against the plain versions and the JAX
fused loss in interpret mode.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu_torch.ops import lm_head_ce as ce

jce = importlib.import_module("apex_tpu.ops.lm_head_ce")

TILE = 128
NEG = -1e30


def test_f32_plan_at_the_o0_shape():
    # n 8192, V 32768: 64 token tiles x 4 slices = 256 blocks, two an SM
    # on the H100's 132; G and G^T of 4096 tokens = 1 GiB; two chunks
    assert ce.f32_vocab_slices(8192, 32768, 132) == 4
    assert ce.f32_chunk_tokens(8192, 32768) == 4096
    assert 2 * 4096 * 32768 * 4 <= ce.F32_WORKSPACE_BYTES
    assert ce.f32_hidden(1024) == 1024
    # chip_smoke.py's other shapes: n 1024 (h 64, 1024 ...), and the O0
    # long path's b2 s4096 (the same 8192 tokens)
    assert ce.f32_vocab_slices(1024, 32768, 132) == 33
    assert ce.f32_chunk_tokens(1024, 32768) == 1024


@pytest.mark.parametrize("n,V,sms,want", [
    (1, 1000, 132, 8),          # one token tile: every vocab tile a slice
    (40, 300, 132, 3),
    (8192, 100, 132, 1),        # one vocab tile
    (65536, 32768, 132, 1),     # 512 token tiles fill the card alone
    (1000, 50257, 132, 33),
])
def test_f32_vocab_slices_ragged(n, V, sms, want):
    got = ce.f32_vocab_slices(n, V, sms)
    assert got == want
    assert 1 <= got <= -(-V // TILE)


@pytest.mark.parametrize("n,V,want", [
    (1000, 1003, 1024),         # one chunk: n rounded up to 128
    (8192, 50257, 2560),        # round4(V) 50260: 2670 tokens, to 128s
    (1, 7, 128),
    (100000, 32768, 4096),
])
def test_f32_chunk_tokens_ragged(n, V, want, monkeypatch):
    got = ce.f32_chunk_tokens(n, V)
    assert got == want and got % TILE == 0
    v4 = -(-V // 4) * 4
    assert got == TILE or 2 * got * v4 * 4 <= ce.F32_WORKSPACE_BYTES
    monkeypatch.setattr(ce, "F32_WORKSPACE_BYTES", 1)
    assert ce.f32_chunk_tokens(n, V) == TILE        # at least one tile


def _fwd_partials(x, e, tgt, slices):
    """The forward kernel's schedule in plain torch: slice s takes
    vocabulary tiles [s per, (s + 1) per) of 128 rows, per = ceil(tiles /
    slices); each slice's (m, l, pred, ssum) over its columns (a slice of
    no tile: -1e30, 0, 0, 0)."""
    n, V = x.shape[0], e.shape[0]
    s = x.float() @ e.float().t()
    tiles = -(-V // TILE)
    per = -(-tiles // slices)
    parts = torch.zeros(4, slices, n)
    parts[0] = NEG
    cols = torch.arange(V)
    for sl in range(slices):
        lo, hi = sl * per * TILE, min(V, (sl + 1) * per * TILE)
        if lo >= hi:
            continue
        blk = s[:, lo:hi]
        m = blk.amax(dim=1)
        parts[0, sl] = m
        parts[1, sl] = torch.exp(blk - m[:, None]).sum(dim=1)
        hit = (tgt.long()[:, None] == cols[None, lo:hi])
        parts[2, sl] = torch.where(hit, blk, torch.zeros_like(blk)).sum(1)
        parts[3, sl] = blk.sum(dim=1)
    return parts


@pytest.mark.parametrize("n,V,slices", [(40, 300, 3), (33, 1003, 4),
                                        (40, 640, 4), (17, 900, 8)])
def test_sliced_forward_combines_to_plain_and_jax(n, V, slices):
    """(40, 640, 4): 5 tiles at 2 a slice leave slice 3 empty; (17, 900, 8):
    8 tiles, one a slice; ragged V everywhere but 640."""
    rng = np.random.RandomState(n + V)
    x = rng.randn(n, 64).astype(np.float32)
    e = (0.3 * rng.randn(V, 64)).astype(np.float32)
    tgt = rng.randint(0, V, n).astype(np.int32)
    tx, te, tt = (torch.from_numpy(a) for a in (x, e, tgt))
    parts = _fwd_partials(tx, te, tt, slices)
    got = ce.combine_partials(parts)
    ref = ce.lm_head_ce_fwd_reference(tx, te, tt, True)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()))
    assert ce.combine_partials(parts[:3])[3] is None
    loss = ce._loss_from_stats(*got, V, 0.1)
    jloss = jce.fused_lm_head_cross_entropy(
        jnp.asarray(x), jnp.asarray(e), jnp.asarray(tgt), 0.1, block_t=16,
        block_v=128, interpret=True, autotune="off")
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss),
                               atol=1e-5 * float(np.abs(jloss).max()),
                               rtol=0)
