"""The decode kernels' split-and-merge orders against the JAX package.

The fp8 dequant-matmul's decode regime (``csrc/fp8_matmul.cu``) cuts K
into the splits of one thread-block cluster and sums their fp32 partials
in split order; paged decode (``csrc/paged_decode.cu``) cuts each row's
live keys into pieces and merges their softmax states (max, sum,
accumulators) in piece order. Both cuts come from Python functions the
wrappers use (``fp8_matmul._splits``, ``flash_attention.paged_decode_pieces``)
and depend on nothing but the row's own length and constants of the shape:
that is what keeps a row bitwise the same whatever rows come with it.

The emulations below are plain PyTorch in fp32 that follow those orders
(as ``tests/test_torch_lm_head_ce.py`` keeps a chunked emulation of the
LM-head backward). Inputs are made with numpy from a seed and handed to
both sides; the JAX side runs its plain version and its Pallas kernel in
interpret mode. Tolerances: fp32 summation order only, 1e-5 (relative to
the largest output for the matmul, absolute for attention, whose outputs
are O(1)); against the Pallas paged kernel over a 16-bit pool 2e-2, since
that kernel rounds p to the pool's dtype before its PV product.
"""

import importlib

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.ops import fp8_matmul as jmm
from apex_tpu_torch.ops import fp8_matmul as tmm

# ``apex_tpu.ops`` re-exports a function of the same name as the module
jfa = importlib.import_module("apex_tpu.ops.flash_attention")
from apex_tpu_torch.ops import flash_attention as tfa  # noqa: E402

E4M3 = torch.float8_e4m3fn


# ---------------------------------------------------------------------------
# paged decode: the cut of a row
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page_size", [8, 16, 128])
@pytest.mark.parametrize("d,pool", [(64, torch.bfloat16), (64, E4M3),
                                    (32, torch.bfloat16), (100, torch.float32),
                                    (512, torch.bfloat16)])
def test_paged_decode_cut_depends_on_the_rows_seq_len_alone(page_size, d,
                                                           pool):
    """Pieces of whole granules, at most ``splits`` of them, covering the
    live keys in order; a function of (seq_len, page_size, d, pool dtype)
    that the wrapper passes to the kernel as (splits, granule)."""
    splits, granule = tfa.paged_decode_split_plan(page_size, d, pool)
    assert 1 <= splits <= 8 and granule >= 16
    assert (splits, granule) == tfa.paged_decode_split_plan(page_size, d,
                                                            pool)
    one_page, many = page_size, 9 * page_size + 3
    for n in (0, 1, granule - 1, granule, granule + 1, one_page, many, 300,
              304, 1024):
        pieces = tfa.paged_decode_pieces(n, page_size, d, pool)
        assert pieces == tfa.paged_decode_pieces(n, page_size, d, pool)
        if n == 0:
            assert pieces == []
            continue
        assert 1 <= len(pieces) <= splits
        assert pieces[0][0] == 0 and pieces[-1][1] == n
        c = pieces[0][1] - pieces[0][0]
        assert c % granule == 0 or len(pieces) == 1
        for (lo, hi), (lo2, _) in zip(pieces, pieces[1:]):
            assert hi == lo2 and hi - lo == c
        assert 0 < pieces[-1][1] - pieces[-1][0] <= c
        if n <= granule:
            assert len(pieces) == 1          # one piece: written directly


def test_paged_decode_cut_at_the_serve_shapes():
    """The serve engine's shapes (d 64, page 128): the spec draft call's one
    row of ~300 keys and each verify row run in 4 pieces (x 16 kv heads =
    64 busy blocks), the mixed batch's longest row in 4 of 256 keys."""
    for pool in (torch.bfloat16, E4M3):
        assert tfa.paged_decode_split_plan(128, 64, pool) == (4, 16)
        for n in (300, 304):
            assert len(tfa.paged_decode_pieces(n, 128, 64, pool)) == 4
        assert tfa.paged_decode_pieces(1024, 128, 64, pool) == [
            (0, 256), (256, 512), (512, 768), (768, 1024)]


# ---------------------------------------------------------------------------
# paged decode: the merge in piece order
# ---------------------------------------------------------------------------

def _paged_split_merge(q, kp, vp, bt, sl, ks=None, vs=None, pool=None):
    """Paged decode by the kernel's order: per (row, kv head, query row),
    each piece's (max, sum, acc) in fp32, then the pieces summed in piece
    order, each weighted by exp(its max - the row's max), as the kernel's
    rank 0 merges them; out = acc / sum."""
    b, kv, g, d = q.shape
    page = kp.shape[2]
    scale = d ** -0.5
    out = torch.zeros(b, kv, g, d, dtype=torch.float32)
    for bi in range(b):
        n = int(min(int(sl[bi]), bt.shape[1] * page))
        pieces = tfa.paged_decode_pieces(n, page, d, pool or kp.dtype)
        pg = bt[bi].long()
        for kh in range(kv):
            k = kp[kh][pg].float().reshape(-1, d)[:n]
            v = vp[kh][pg].float().reshape(-1, d)[:n]
            if ks is not None:
                kss = ks[kh][pg].repeat_interleave(page)[:n, None]
                vss = vs[kh][pg].repeat_interleave(page)[:n, None]
            for gi in range(g):
                s = (k @ q[bi, kh, gi].float())
                s = s / kss[:, 0] * scale if ks is not None else s * scale
                states = []
                for lo, hi in pieces:
                    m = s[lo:hi].max()
                    p = torch.exp(s[lo:hi] - m)
                    pv = p[:, None] / vss[lo:hi] if vs is not None \
                        else p[:, None]
                    states.append((m, p.sum(), (pv * v[lo:hi]).sum(0)))
                if not states:
                    continue
                M = max(st[0] for st in states)
                L, A = 0.0, 0.0
                for m, l, a in states:
                    e = torch.exp(m - M)
                    L, A = L + l * e, A + a * e
                out[bi, kh, gi] = A / L
    return out


@pytest.mark.parametrize("pool", ["bfloat16", "e4m3"])
def test_paged_split_merge_matches_jax(pool):
    """GQA group 3, a dead slot, a partial page, rows of one, three and
    four pieces (page 8, granule 16) and a row past its table's keys."""
    rng = np.random.RandomState(11)
    b, kv, g, d, page, n_pages, m = 4, 2, 3, 64, 8, 57, 14
    q = (rng.randn(b, kv, g, d) * 0.3).astype(np.float32)
    kp = (rng.randn(kv, n_pages, page, d) * 0.3).astype(np.float32)
    vp = (rng.randn(kv, n_pages, page, d) * 0.3).astype(np.float32)
    bt = rng.permutation(np.arange(1, n_pages))[:b * m].reshape(b, m)
    bt = bt.astype(np.int32)
    sl = np.asarray([13, 0, 40, 120], np.int32)
    jkw, tkw = {}, {}
    if pool == "e4m3":
        sc = (rng.rand(kv, n_pages) + 0.5).astype(np.float32)
        kq = (kp * sc[:, :, None, None]).astype(ml_dtypes.float8_e4m3fn)
        vq = (vp * sc[:, :, None, None]).astype(ml_dtypes.float8_e4m3fn)
        jk, jv = jnp.asarray(kq), jnp.asarray(vq)
        tk, tv = (torch.from_numpy(a.view(np.uint8)).view(E4M3)
                  for a in (kq, vq))
        jkw = dict(k_scales=jnp.asarray(sc), v_scales=jnp.asarray(sc))
        tkw = dict(ks=torch.from_numpy(sc), vs=torch.from_numpy(sc))
        kernel_tol = 1e-5
    else:
        kb = kp.astype(ml_dtypes.bfloat16)
        vb = vp.astype(ml_dtypes.bfloat16)
        jk, jv = jnp.asarray(kb), jnp.asarray(vb)
        tk = torch.from_numpy(kb.astype(np.float32)).to(torch.bfloat16)
        tv = torch.from_numpy(vb.astype(np.float32)).to(torch.bfloat16)
        kernel_tol = 2e-2                     # the kernel rounds p to bf16
    assert [len(tfa.paged_decode_pieces(int(n), page, d, tk.dtype))
            for n in sl] == [1, 0, 3, 4]
    got = _paged_split_merge(torch.from_numpy(q), tk, tv,
                             torch.from_numpy(bt), torch.from_numpy(sl),
                             **tkw)
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(sl))
    ref = np.asarray(jfa.paged_attention_reference(*jargs, **jkw))
    ker = np.asarray(jfa.paged_decode_attention(*jargs, interpret=True,
                                                **jkw))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), ker, atol=kernel_tol, rtol=0)
    assert float(got[1].abs().max()) == 0.0
    # and the port's plain version, which the card is checked against
    plain = tfa.paged_attention_reference(
        torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
        torch.from_numpy(sl), k_scales=tkw.get("ks"), v_scales=tkw.get("vs"))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the fp8 dequant-matmul's decode regime: the K splits in split order
# ---------------------------------------------------------------------------

def _fp8_split_sum(x, q, scale):
    """The decode regime's order: each split's fp32 partial over its rows,
    the partials summed in split order, then divided by the scale."""
    K, N = q.shape
    splits, kc = tmm._splits(K, N)
    tot = torch.zeros(x.shape[0], N, dtype=torch.float32)
    for r in range(splits):
        lo, hi = r * kc, min(K, (r + 1) * kc)
        if lo < hi:
            tot = tot + x[:, lo:hi].float() @ q[lo:hi].float()
    return tot / scale


@pytest.mark.parametrize("m,K,N", [(8, 1024, 384), (1, 256, 128),
                                   (5, 640, 256)])
def test_fp8_split_sum_matches_jax(m, K, N):
    rng = np.random.RandomState(K + m)
    x = rng.randn(m, K).astype(np.float32)
    w = (rng.randn(K, N) * K ** -0.5).astype(np.float32)
    qj, sj = jmm.quantize_weight(jnp.asarray(w))
    q8 = np.array(qj)
    tq = torch.from_numpy(q8.view(np.uint8)).view(E4M3)
    ts = torch.from_numpy(np.asarray(sj))
    assert tmm._splits(K, N)[0] > 1
    got = _fp8_split_sum(torch.from_numpy(x), tq, ts).numpy()
    ref = np.asarray(jmm.fp8_dequant_matmul_reference(
        jnp.asarray(x), qj, sj))
    ker = np.asarray(jmm.fp8_dequant_matmul(
        jnp.asarray(x), qj, sj, block_k=128, block_n=128, interpret=True))
    for want in (ref, ker):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
