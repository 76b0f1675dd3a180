"""The flash backward's fp32 (O0) FFMA route, on the CPU.

fp32 operands at kernel head dims 64 and 128 that round nothing below
fp32 run the single pass and the split's dk/dv on the exact-FFMA kernels
of ``csrc/flash_bwd_f32.cuh`` (``f32_core_route``); everything else keeps
its kernels. The kernels run only on the card
(``tests/test_torch_cuda_kernels.py``); here:

- the route's predicate, by dtype, kernel head dim and roundings;
- its dq turn plan (``single_pass_dq_order`` with ``"flash_bwd_f32"``):
  each reaching key block once, in descending order, each waiting only
  for a block its grid (b h, key block in reverse) dispatched before it;
- a torch emulation of the kernels' tiling — key blocks of
  ``f32_core_keys(kd)`` keys, the 64-row query tiles that reach them
  streamed from transposed copies of q and dO padded to 4 columns, P and
  dS staged per tile, dq partials stored by each tile's first contributor
  and added by the rest in the turn order — held against
  the JAX package's backward (``_flash_bwd_impl``, single pass and split)
  in Pallas interpret mode. Tolerance: 1e-5 of the largest gradient
  (fp32 on both sides, sums in another order).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("apex_tpu.ops.flash_attention")

F32 = "flash_bwd_f32"
ROWS = 64
NO_ROUNDS = 0x2A


@pytest.mark.parametrize("kd", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("rounds", [NO_ROUNDS, 0x2B, 0x28, 0x0A, 0])
def test_f32_core_route_by_dtype_head_dim_and_rounds(dtype, kd, rounds):
    want = (dtype == torch.float32 and kd in (64, 128)
            and rounds == NO_ROUNDS)
    assert tfa.f32_core_route(dtype, kd, rounds) is want


@pytest.mark.parametrize("dtypes,takes", [
    ((torch.float32,) * 4, True),
    # v in bf16, promoted exactly: p is cast to dout's dtype (fp32) and ds
    # to q's and k's (fp32), so nothing rounds
    ((torch.float32, torch.float32, torch.bfloat16, torch.float32), True),
    ((torch.bfloat16, torch.float32, torch.float32, torch.float32), False),
    ((torch.float32, torch.float16, torch.float32, torch.float32), False),
    ((torch.float32, torch.float32, torch.float32, torch.bfloat16), False),
])
def test_mixed_operands_take_the_route_only_when_nothing_rounds(dtypes,
                                                                takes):
    q, k, v, do = (torch.zeros(1, 1, 4, 64, dtype=dt) for dt in dtypes)
    rounds = tfa._mixed_rounds(q, k, do)
    _, dtype = tfa._promoted(q, k, v, do)
    assert tfa.f32_core_route(dtype, 64, rounds) is takes
    # the split's source stays flash_bwd.cu's (its fp32 build)
    assert tfa.split_route(dtype, 64) == "flash_bwd"


def test_keys_a_block():
    assert tfa.f32_core_keys(64) == 128
    assert tfa.f32_core_keys(128) == 64


def _reach(sq, sk, causal, keys):
    """Brute force: the key blocks a query tile's rows see a key of."""
    n_qt, n_kb = -(-sq // ROWS), -(-sk // keys)
    off = sk - sq
    return [[j for j in range(n_kb)
             if any(not causal or j * keys <= r + off
                    for r in range(qt * ROWS, min(sq, qt * ROWS + ROWS)))]
            for qt in range(n_qt)]


SHAPES = [
    (1024, 1024, True),      # the O0 cell's single pass (b8 h16)
    (1024, 1024, False),
    (1000, 1003, True),      # ragged, sq != sk
    (300, 300, True),
    (100, 300, True),        # sq < sk: the offset reaches keys early
    (300, 100, True),        # sq > sk: the first tiles see no key at all
    (65, 700, False),
]


@pytest.mark.parametrize("kd", [64, 128])
@pytest.mark.parametrize("sq,sk,causal", SHAPES)
def test_turn_plan_covers_each_reaching_block_once(sq, sk, causal, kd):
    keys = tfa.f32_core_keys(kd)
    order = tfa.single_pass_dq_order(sq, sk, causal, F32, kd)
    n_kb = -(-sk // keys)
    assert len(order) == -(-sq // ROWS)
    for qt, (o, r) in enumerate(zip(order, _reach(sq, sk, causal, keys))):
        assert sorted(o) == r, qt
        assert o == list(range(len(o)))[::-1], qt
        # the kernel's turn for block j: J - j, J from the tile's last row
        last = (min(n_kb - 1, (ROWS * qt + ROWS - 1 + sk - sq) // keys)
                if causal else n_kb - 1)
        assert [last - j for j in o] == list(range(len(o))), qt


@pytest.mark.parametrize("kd", [64, 128])
@pytest.mark.parametrize("sq,sk,causal", SHAPES)
def test_each_block_waits_only_for_an_earlier_dispatched_block(sq, sk,
                                                               causal, kd):
    """Grid (b h, key block in reverse): block j of (batch, head) 1 at
    linear index 1 + bh (n_kb - 1 - j), one round of b h blocks a key
    block."""
    bh = 6
    n_kb = -(-sk // tfa.f32_core_keys(kd))

    def linear(j):
        return 1 + bh * (n_kb - 1 - j)

    for o in tfa.single_pass_dq_order(sq, sk, causal, F32, kd):
        for prev, cur in zip(o, o[1:]):
            assert linear(prev) < linear(cur)


@pytest.mark.parametrize("kd", [64, 128])
def test_workspace_holds_a_counter_a_tile(kd):
    """The FFMA route writes every dq element (each tile's first
    contributor stores), so only the turn counters are zeroed."""
    b, h, sq = 2, 3, 130
    q = torch.empty(b, h, sq, kd)
    dq_acc, turns = tfa._dq_workspace(q, kd, F32)
    want = b * h * -(-sq // ROWS)           # every column in one block
    assert turns.numel() == tfa.single_pass_turns(b, h, sq, kd, F32) == want
    assert dq_acc.shape == q.shape and dq_acc.dtype == torch.float32
    assert turns.dtype == torch.int32 and not turns.any()
    # the existing routes keep their counts
    assert tfa.single_pass_turns(b, h, sq, kd, True) == want
    assert tfa.single_pass_turns(b, h, sq, kd, False) == want * (kd // 32)


def test_transposed_scratch_pads_query_columns_to_four():
    q = torch.empty(2, 3, 1001, 64)
    assert tfa._f32_transposes(q).numel() == 2 * 2 * 3 * 64 * 1004


def _emulate(q, k, v, do, lse, delta, sid_q, sid_kv, causal, scale, single):
    """The FFMA kernels' tiling in torch fp32: (dq, dk, dv), dq None for
    the split's dk/dv kernel."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    kd = tfa.kernel_head_dim(d)
    pad = [0, kd - d]
    q, k, v, do = (torch.nn.functional.pad(t, pad) for t in (q, k, v, do))
    bn, off = tfa.f32_core_keys(kd), sk - sq
    n_kb, n_qt = -(-sk // bn), -(-sq // ROWS)
    sqp = -(-sq // 4) * 4
    # the C entry's transposed copies: [b, h, kd, sqp], zero past sq
    qt_, dot_ = (torch.zeros(b, h, kd, sqp) for _ in range(2))
    qt_[..., :sq] = q.transpose(-1, -2)
    dot_[..., :sq] = do.transpose(-1, -2)
    dk, dv = torch.zeros(b, h, sk, kd), torch.zeros(b, h, sk, kd)
    partials = {}
    for j in range(n_kb):
        n0 = j * bn
        nk = min(bn, sk - n0)
        kt, vt = torch.zeros(b, h, kd, bn), torch.zeros(b, h, kd, bn)
        kt[..., :nk] = k[:, :, n0:n0 + nk].transpose(-1, -2)
        vt[..., :nk] = v[:, :, n0:n0 + nk].transpose(-1, -2)
        key = torch.arange(n0, n0 + bn)
        dka, dva = torch.zeros(b, h, bn, kd), torch.zeros(b, h, bn, kd)
        for t in range(max(0, n0 - off) // ROWS if causal else 0, n_qt):
            q0 = t * ROWS
            cols = slice(q0, min(q0 + ROWS, sqp))
            qtile, dtile = (torch.zeros(b, h, kd, ROWS) for _ in range(2))
            w = cols.stop - cols.start
            qtile[..., :w] = qt_[..., cols]
            dtile[..., :w] = dot_[..., cols]
            qr = torch.arange(q0, q0 + ROWS)
            s_t = torch.einsum("bhdk,bhdq->bhkq", kt, qtile)
            dp_t = torch.einsum("bhdk,bhdq->bhkq", vt, dtile)
            ok = (qr[None, :] < sq) & (key[:, None] < sk)
            if causal:
                ok = ok & (key[:, None] <= qr[None, :] + off)
            ok = ok[None, None].expand(b, h, bn, ROWS)
            if sid_q is not None:
                sq_ = torch.full((b, ROWS), -1, dtype=torch.int32)
                sk_ = torch.full((b, bn), -2, dtype=torch.int32)
                sq_[:, :min(ROWS, sq - q0)] = sid_q[:, q0:q0 + ROWS]
                sk_[:, :nk] = sid_kv[:, n0:n0 + nk]
                seg = (sq_[:, None, :] >= 0) & (sk_[:, :, None]
                                                == sq_[:, None, :])
                ok = ok & seg[:, None]
            lse_t, dl_t = (torch.zeros(b, h, ROWS) for _ in range(2))
            live = min(ROWS, sq - q0)
            lse_t[..., :live] = lse[..., q0:q0 + live]
            dl_t[..., :live] = delta[..., q0:q0 + live]
            p = torch.where(ok, torch.exp(s_t * scale - lse_t[:, :, None]),
                            torch.zeros(()))
            ds = p * (dp_t - dl_t[:, :, None])
            dva += torch.einsum("bhkq,bhdq->bhkd", p, dtile)
            dka += torch.einsum("bhkq,bhdq->bhkd", ds, qtile)
            if single:
                partials[t, j] = torch.einsum("bhkq,bhdk->bhqd", ds, kt)
        dk[:, :, n0:n0 + nk] = dka[:, :, :nk] * scale
        dv[:, :, n0:n0 + nk] = dva[:, :, :nk]
    dq = None
    if single:
        # the workspace is not zeroed: the prologue zeroes the rows no key
        # block reaches, each tile's first contributor stores, the rest add
        dq = torch.full((b, h, sq, kd), float("nan"))
        if causal:
            dq[:, :, :min(sq, max(0, sq - sk))] = 0.0
        order = tfa.single_pass_dq_order(sq, sk, causal, F32, kd)
        assert sorted(partials) == sorted((t, j) for t, o in enumerate(order)
                                          for j in o)
        for t, o in enumerate(order):
            rows = slice(t * ROWS, min(sq, t * ROWS + ROWS))
            live = rows.stop - rows.start
            for pos, j in enumerate(o):  # descending: the turn order
                part = partials[t, j][:, :, :live] * scale
                dq[:, :, rows] = part if pos == 0 else dq[:, :, rows] + part
        assert not dq.isnan().any()      # every element written
        dq = dq[..., :d]
    return dq, dk[..., :d], dv[..., :d]


CASES = [
    # b, h, sq, sk, d, causal, segments
    (1, 2, 256, 256, 64, True, False),
    (1, 2, 256, 256, 64, False, False),
    (2, 1, 203, 203, 64, True, True),       # ragged, padding rows
    (1, 2, 100, 300, 64, True, False),      # sq < sk
    (1, 2, 300, 100, 64, True, False),      # sq > sk: rows with no key
    (1, 1, 200, 200, 40, True, False),      # d 40 -> 64
    (1, 1, 160, 160, 128, True, False),
    (1, 1, 150, 150, 80, False, True),      # d 80 -> 128
]


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg", CASES)
def test_tiling_emulation_matches_jax(b, h, sq, sk, d, causal, seg, split,
                                      monkeypatch):
    rng = np.random.RandomState(sq * 7 + sk + d)
    q, do = (rng.randn(b, h, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, sk, d).astype(np.float32) for _ in range(2))
    kw, tkw = dict(causal=causal), dict(causal=causal)
    sid_q = sid_kv = None
    if seg:
        sid = (rng.randint(0, 3, (b, sq)).cumsum(-1) // 2).astype(np.int32)
        sid[:, -20:] = -1                                   # padding rows
        kw.update(segment_ids_q=jnp.asarray(sid))
        sid_q = sid_kv = torch.from_numpy(sid)
        tkw.update(segment_ids_q=sid_q)
    if split:
        monkeypatch.setattr(jfa, "_FUSED_BWD_MAX_KV_BYTES", 0)

    def jf(qq, kk, vv):
        return jfa.flash_attention(qq, kk, vv, block_q=128, block_k=128,
                                   block_q_bwd=128, block_k_bwd=128,
                                   interpret=True, autotune="off", **kw)

    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = tfa.flash_attention_reference(tq, tk, tv, **tkw)
    delta = (tdo * out).sum(-1)
    dq, dk, dv = _emulate(tq, tk, tv, tdo, lse, delta, sid_q, sid_kv,
                          causal, d ** -0.5, not split)
    got = (dk, dv) if split else (dq, dk, dv)
    for g, r in zip(got, jgrads[1:] if split else jgrads):
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * float(np.abs(r).max()))
    if seg and not split:           # padding rows: dq exactly zero
        pad = (sid_q < 0)[:, None, :].expand(dq.shape[:3])
        assert not bool(dq[pad].any())


def test_cpu_calls_count_no_launch():
    f = tfa.flash_attention_bwd
    names = ("launches", "wgmma_launches", "f32_launches", "dkdv_launches",
             "dq_launches", "wgmma_dkdv_launches", "wgmma_dq_launches",
             "f32_dkdv_launches")
    before = [getattr(f, n) for n in names]
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 2, 40, 64, generator=g) for _ in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    tfa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    qr = q.clone().requires_grad_()
    tfa.flash_attention(qr, k, v, causal=True).sum().backward()
    assert [getattr(f, n) for n in names] == before
