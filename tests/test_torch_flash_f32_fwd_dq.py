"""The fp32 (O0) flash forward and the split's dq on their FFMA route, on
the CPU.

fp32 operands at kernel head dims 64 and 128 run the forward on
``flash_fwd_f32_kernel`` (``csrc/flash_fwd_f32.cuh``) where nothing is
rounded before the PV product (``f32_fwd_route``), and the split's dq on
``flash_dq_f32_kernel`` (``csrc/flash_bwd_f32.cuh``) where the backward
rounds nothing (``f32_core_route``, which also routes the single pass and
the split's dk/dv). The kernels run only on the card
(``tests/test_torch_cuda_kernels.py``); here:

- the forward's predicate, by dtype, kernel head dim and the dtype p is
  rounded to;
- the wrappers' C calls, recorded through a stand-in for the built
  library: which entry each dtype and head dim reaches, and the split's
  dk/dv and dq sharing one scratch of q and dO transposed (the dq call
  runs no prologue of its own), alone the dq call transposing for itself;
- torch emulations of the two kernels' tilings held against the JAX
  package in Pallas interpret mode: the forward's (resident query tiles
  of 64 rows, streamed key tiles of 32, the online max and sum rescale,
  the causal stop) against ``_flash_fwd_impl`` — out within 1e-5, lse
  within 1e-5 relative; the dq kernel's (resident query tiles of 128 rows
  at d 64 and 64 at d 128 read from the transposed scratch, streamed key
  tiles of 64, dQ accumulated tile by tile in key order) against the JAX
  split (``_flash_bwd_impl`` past its gate) — within 1e-5 of the largest
  gradient (fp32 on both sides, sums in another order);
- CPU calls of the wrappers count no launch.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("apex_tpu.ops.flash_attention")

NO_ROUNDS = 0x2A
F32 = torch.float32


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kd", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, F32])
@pytest.mark.parametrize("p_round", [0, 1, 2])
def test_f32_fwd_route_by_dtype_head_dim_and_p_round(dtype, kd, p_round):
    want = dtype == F32 and kd in (64, 128) and p_round == 2
    assert tfa.f32_fwd_route(dtype, kd, p_round) is want
    # the wgmma route keeps bf16 and fp16; the two never both hold
    assert not (want and tfa.sm90_route(dtype, kd))


@pytest.mark.parametrize("kd", [64, 128])
def test_f32_core_route_covers_the_split_dq(kd):
    """One predicate for the whole fp32 backward: the split's dq takes
    the FFMA route wherever its dk/dv does."""
    assert tfa.f32_core_route(F32, kd, NO_ROUNDS)
    assert "dq" in tfa.f32_core_route.__doc__
    assert tfa.split_route(F32, kd) == "flash_bwd"   # its fp32 build


class _Library:
    """Stands in for ``_build.function``: records each C call (target,
    symbol, arguments) and returns success."""

    def __init__(self):
        self.calls = []

    def function(self, target, symbol, argtypes):
        def call(*args):
            assert len(args) == len(argtypes), symbol
            self.calls.append((target, symbol, args))
            return 0
        return call


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(tfa._build, "function", lib.function)
    monkeypatch.setattr(tfa._build, "check", lambda err, what: None)
    monkeypatch.setattr(tfa, "_stream", lambda t: None)
    for fn, names in ((tfa.flash_attention, ("launches", "wgmma_launches",
                                             "f32_launches")),
                      (tfa.flash_attention_bwd, (
                          "launches", "dkdv_launches", "dq_launches",
                          "f32_dkdv_launches", "f32_dq_launches",
                          "wgmma_dkdv_launches", "wgmma_dq_launches",
                          "f32_launches"))):
        for n in names:
            monkeypatch.setattr(fn, n, 0)
    return lib


def _ptr(arg):
    return arg.value if arg is not None else None


@pytest.mark.parametrize("dtypes,d,symbol", [
    ((F32,) * 3, 64, "apex_flash_fwd_f32"),
    ((F32,) * 3, 128, "apex_flash_fwd_f32"),
    ((F32,) * 3, 40, "apex_flash_fwd_f32"),       # padded to 64
    ((F32,) * 3, 80, "apex_flash_fwd_f32"),       # padded to 128
    ((F32,) * 3, 32, "apex_flash_fwd"),
    ((F32,) * 3, 256, "apex_flash_fwd"),
    # promoted to fp32; v fp32: p rounds to fp32, nothing rounded
    ((torch.bfloat16, F32, F32), 64, "apex_flash_fwd_f32"),
    # v bf16: the JAX kernel rounds p to bf16 before the PV product
    ((F32, F32, torch.bfloat16), 64, "apex_flash_fwd"),
    ((torch.bfloat16,) * 3, 32, "apex_flash_fwd"),
])
def test_forward_calls_the_entry_of_its_route(library, dtypes, d, symbol):
    q, k, v = (torch.zeros(1, 2, 70, d, dtype=dt) for dt in dtypes)
    out, lse = tfa._flash_fwd_cuda(q, k, v, None, None, True, 0.125)
    assert [c[1] for c in library.calls] == [symbol]
    target = library.calls[0][0]
    assert target == ("flash_fwd@f32" if symbol.endswith("f32")
                      or F32 in dtypes else "flash_fwd@bf16")
    assert out.dtype == dtypes[0] and out.shape == (1, 2, 70, d)
    assert tfa.flash_attention.launches == 1
    assert tfa.flash_attention.f32_launches == int(symbol.endswith("f32"))


@pytest.mark.parametrize("d", [64, 128, 80])
@pytest.mark.parametrize("seg", [False, True])
def test_fp32_split_shares_one_transposed_scratch(library, d, seg):
    """dk/dv (its prologue: q and do transposed, delta folded), then dq
    reading that scratch and that delta, with no prologue of its own."""
    b, h, sq, sk = 2, 2, 50, 60
    q, do = torch.zeros(b, h, sq, d), torch.zeros(b, h, sq, d)
    k, v = torch.zeros(b, h, sk, d), torch.zeros(b, h, sk, d)
    out, lse = torch.zeros(b, h, sq, d), torch.zeros(b, h, sq)
    sid_q = torch.zeros(b, sq, dtype=torch.int32) if seg else None
    sid_kv = torch.zeros(b, sk, dtype=torch.int32) if seg else None
    dq, dk, dv = tfa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv,
                                     True, 0.125, split=True)
    (t1, s1, a1), (t2, s2, a2) = library.calls
    assert (t1, s1) == ("flash_bwd@f32", "apex_flash_bwd_f32_dkdv")
    assert (t2, s2) == ("flash_bwd@f32", "apex_flash_bwd_f32_dq")
    # dk/dv: (q, k, v, do, out, lse, delta, sid_q, sid_kv, ws, dk, dv, ...)
    # dq: (q, k, v, do, lse, delta, sid_q, sid_kv, ws, transposed, dq, ...)
    assert _ptr(a1[4]) is not None                  # the delta fold
    assert _ptr(a1[6]) == _ptr(a2[5])               # the folded delta
    assert _ptr(a1[9]) == _ptr(a2[8])               # one scratch
    assert a2[9] == 1                               # already transposed
    assert _ptr(a1[0]) == _ptr(a2[0]) and _ptr(a1[3]) == _ptr(a2[3])
    kd = tfa.kernel_head_dim(d)
    assert a2[11:17] == (b, h, sq, sk, kd, 1)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    f = tfa.flash_attention_bwd
    assert (f.launches, f.dkdv_launches, f.dq_launches, f.f32_dkdv_launches,
            f.f32_dq_launches) == (0, 1, 1, 1, 1)


def test_dq_alone_transposes_for_itself(library):
    q, k, v, do = (torch.zeros(1, 2, 33, 64) for _ in range(4))
    lse, delta = torch.zeros(1, 2, 33), torch.zeros(1, 2, 33)
    dq = tfa._flash_dq_cuda(q, k, v, do, lse, delta, None, None, False,
                            0.125, NO_ROUNDS)
    ((target, symbol, args),) = library.calls
    assert (target, symbol) == ("flash_bwd@f32", "apex_flash_bwd_f32_dq")
    assert args[9] == 0 and _ptr(args[8]) is not None
    assert dq.shape == q.shape
    assert tfa.flash_attention_bwd.f32_dq_launches == 1
    with pytest.raises(ValueError, match="delta"):
        tfa._flash_dq_cuda(q, k, v, do, lse, delta, None, None, False,
                           0.125, NO_ROUNDS, out=q)


@pytest.mark.parametrize("dtypes,d", [
    ((F32,) * 4, 32), ((F32,) * 4, 256),
    ((torch.bfloat16, F32, F32, F32), 64),    # ds rounded to q's dtype
    ((F32, F32, F32, torch.bfloat16), 64),    # p rounded to do's dtype
])
def test_other_fp32_splits_keep_flash_bwd_cu(library, dtypes, d):
    q, k, v, do = (torch.zeros(1, 2, 40, d, dtype=dt) for dt in dtypes)
    out, lse = torch.zeros(1, 2, 40, d), torch.zeros(1, 2, 40)
    tfa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, True, 0.125,
                        split=True)
    assert [c[1] for c in library.calls] == ["apex_flash_bwd_dkdv",
                                             "apex_flash_bwd_dq"]
    assert tfa.flash_attention_bwd.f32_dq_launches == 0


# ---------------------------------------------------------------------------
# the tilings, emulated in torch fp32, against the JAX kernels
# ---------------------------------------------------------------------------

FWD_ROWS, FWD_KEYS = 64, 32             # flash_fwd_f32.cuh: Cfg's BQ, BN


def _dq_rows(kd):
    return 128 if kd == 64 else 64       # flash_bwd_f32.cuh: DqCfg::BQ


DQ_KEYS = 64                             # DqCfg::BN


def _mask(rows, keys, sq, sk, causal, sid_q, sid_kv, b):
    """[b, 1, rows, keys] validity of a (query tile, key tile) block."""
    ok = (rows[:, None] < sq) & (keys[None, :] < sk)
    if causal:
        ok = ok & (keys[None, :] <= rows[:, None] + (sk - sq))
    ok = ok[None].expand(b, -1, -1)
    if sid_q is not None:
        sq_ = torch.full((b, rows.numel()), -1, dtype=torch.int32)
        sk_ = torch.full((b, keys.numel()), -2, dtype=torch.int32)
        lq = max(0, min(rows.numel(), sq - int(rows[0])))
        lk = max(0, min(keys.numel(), sk - int(keys[0])))
        sq_[:, :lq] = sid_q[:, int(rows[0]):int(rows[0]) + lq]
        sk_[:, :lk] = sid_kv[:, int(keys[0]):int(keys[0]) + lk]
        ok = ok & (sq_[:, :, None] >= 0) & (sq_[:, :, None]
                                            == sk_[:, None, :])
    return ok[:, None]


def _tile(t, start, size):
    """Rows [start, start + size) of t [b, h, n, d], zeros past n."""
    out = torch.zeros(*t.shape[:2], size, t.shape[3])
    live = max(0, min(size, t.shape[2] - start))
    out[:, :, :live] = t[:, :, start:start + live]
    return out


def _kt_end(q0, rows, sq, sk, keys, causal):
    n_kt = -(-sk // keys)
    if not causal:
        return n_kt
    last = min(sq - 1, q0 + rows - 1) + sk - sq
    return 0 if last < 0 else min(n_kt, last // keys + 1)


def _emulate_fwd(q, k, v, sid_q, sid_kv, causal, scale):
    """flash_fwd_f32_kernel's tiling: (out, lse)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    kd = tfa.kernel_head_dim(d)
    q, k, v = (torch.nn.functional.pad(t, [0, kd - d]) for t in (q, k, v))
    bq, bn = FWD_ROWS, FWD_KEYS
    out, lse = torch.zeros(b, h, sq, kd), torch.zeros(b, h, sq)
    for t in range(-(-sq // bq)):
        q0 = t * bq
        rows = torch.arange(q0, q0 + bq)
        qt = _tile(q, q0, bq)
        m = torch.full((b, h, bq), -1e30)
        l = torch.zeros(b, h, bq)
        o = torch.zeros(b, h, bq, kd)
        for kt in range(_kt_end(q0, bq, sq, sk, bn, causal)):
            keys = torch.arange(kt * bn, kt * bn + bn)
            kb, vb = _tile(k, kt * bn, bn), _tile(v, kt * bn, bn)
            s = torch.einsum("bhqd,bhkd->bhqk", qt, kb)
            ok = _mask(rows, keys, sq, sk, causal, sid_q, sid_kv, b)
            val = torch.where(ok, s * scale, torch.tensor(-1e30))
            mn = torch.maximum(m, val.amax(-1))
            p = torch.where(ok, torch.exp(val - mn[..., None]),
                            torch.zeros(()))
            alpha = torch.exp(m - mn)
            l = alpha * l + p.sum(-1)
            m = mn
            o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        live = min(bq, sq - q0)
        sl = torch.where(l > 0, l, torch.ones(()))
        out[:, :, q0:q0 + live] = (o / sl[..., None])[:, :, :live]
        lse[:, :, q0:q0 + live] = (m + torch.log(sl))[:, :, :live]
    return out[..., :d], lse


def _emulate_dq(q, k, v, do, lse, delta, sid_q, sid_kv, causal, scale):
    """flash_dq_f32_kernel's tiling: dq, from the transposed scratch."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    kd = tfa.kernel_head_dim(d)
    q, k, v, do = (torch.nn.functional.pad(t, [0, kd - d])
                   for t in (q, k, v, do))
    sqp = -(-sq // 4) * 4
    # the dk/dv prologue's copies: [b, h, kd, sqp], zero past sq
    qt_, dt_ = torch.zeros(b, h, kd, sqp), torch.zeros(b, h, kd, sqp)
    qt_[..., :sq] = q.transpose(-1, -2)
    dt_[..., :sq] = do.transpose(-1, -2)
    bq = _dq_rows(kd)
    dq = torch.full((b, h, sq, kd), float("nan"))
    for t in range(-(-sq // bq)):
        q0 = t * bq
        rows = torch.arange(q0, q0 + bq)
        qtile, dtile = torch.zeros(b, h, kd, bq), torch.zeros(b, h, kd, bq)
        w = max(0, min(bq, sqp - q0))
        qtile[..., :w] = qt_[..., q0:q0 + w]
        dtile[..., :w] = dt_[..., q0:q0 + w]
        lse_t = _tile(lse[..., None], q0, bq)[..., 0]
        dl_t = _tile(delta[..., None], q0, bq)[..., 0]
        dqa = torch.zeros(b, h, bq, kd)
        for kt in range(_kt_end(q0, bq, sq, sk, DQ_KEYS, causal)):
            keys = torch.arange(kt * DQ_KEYS, kt * DQ_KEYS + DQ_KEYS)
            kb, vb = _tile(k, kt * DQ_KEYS, DQ_KEYS), _tile(v, kt * DQ_KEYS,
                                                             DQ_KEYS)
            s = torch.einsum("bhdq,bhkd->bhqk", qtile, kb)
            dp = torch.einsum("bhdq,bhkd->bhqk", dtile, vb)
            ok = _mask(rows, keys, sq, sk, causal, sid_q, sid_kv, b)
            p = torch.where(ok, torch.exp(s * scale - lse_t[..., None]),
                            torch.zeros(()))
            ds = p * (dp - dl_t[..., None])
            # stored [key][query]; dQ over the tile's keys (k = key)
            dqa = dqa + torch.einsum("bhkq,bhkd->bhqd", ds.transpose(-1, -2),
                                     kb)
        live = min(bq, sq - q0)
        dq[:, :, q0:q0 + live] = dqa[:, :, :live] * scale
    assert not dq.isnan().any()          # every row written once
    return dq[..., :d]


CASES = [
    # b, h, sq, sk, d, causal, segments
    (1, 2, 256, 256, 64, True, False),
    (1, 2, 256, 256, 64, False, False),
    (2, 1, 203, 203, 64, True, True),       # ragged, padding rows
    (1, 2, 100, 300, 64, True, False),      # sq < sk
    (1, 2, 300, 100, 64, True, False),      # sq > sk: rows with no key
    (1, 1, 200, 200, 40, True, False),      # d 40 -> 64
    (1, 1, 160, 160, 128, True, False),
    (1, 1, 150, 170, 80, False, True),      # d 80 -> 128, sq != sk
]


def _inputs(b, h, sq, sk, d, seg):
    rng = np.random.RandomState(sq * 7 + sk + d)
    q, do = (rng.randn(b, h, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, sk, d).astype(np.float32) for _ in range(2))
    sid_q = sid_kv = None
    if seg:
        sid_q = (rng.randint(0, 3, (b, sq)).cumsum(-1) // 2).astype(np.int32)
        sid_q[:, -20:] = -1                                 # padding rows
        sid_kv = sid_q if sk == sq else (
            rng.randint(0, 3, (b, sk)).cumsum(-1) // 2).astype(np.int32)
    return q, k, v, do, sid_q, sid_kv


@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg", CASES)
def test_forward_tiling_emulation_matches_jax(b, h, sq, sk, d, causal, seg):
    q, k, v, _, sid_q, sid_kv = _inputs(b, h, sq, sk, d, seg)
    scale = d ** -0.5
    jout, jlse = jfa._flash_fwd_impl(
        *(jnp.asarray(a) for a in (q, k, v)),
        None if sid_q is None else jnp.asarray(sid_q),
        None if sid_kv is None else jnp.asarray(sid_kv), None,
        jnp.zeros((1,), jnp.int32), scale, causal, 0.0, 128, 128, True)
    tsq, tsk = (None if s_ is None else torch.from_numpy(s_)
                for s_ in (sid_q, sid_kv))
    out, lse = _emulate_fwd(*(torch.from_numpy(a) for a in (q, k, v)), tsq,
                            tsk, causal, scale)
    jout = np.asarray(jout, np.float32)
    jlse = np.asarray(jlse, np.float32).reshape(b, h, -1)[:, :, :sq]
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=1e-5, atol=0)
    if seg:                 # padding rows: exactly zero, lse the fill
        pad = np.broadcast_to((sid_q < 0)[:, None, :], (b, h, sq))
        assert not out.numpy()[pad].any()
        assert np.all(lse.numpy()[pad] == np.float32(-1e30))


@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg", CASES)
def test_dq_tiling_emulation_matches_jax_split(b, h, sq, sk, d, causal, seg,
                                               monkeypatch):
    q, k, v, do, sid_q, sid_kv = _inputs(b, h, sq, sk, d, seg)
    kw = dict(causal=causal)
    tkw = dict(causal=causal)
    tsq = tsk = None
    if seg:
        kw.update(segment_ids_q=jnp.asarray(sid_q),
                  segment_ids_kv=jnp.asarray(sid_kv))
        tsq, tsk = torch.from_numpy(sid_q), torch.from_numpy(sid_kv)
        tkw.update(segment_ids_q=tsq, segment_ids_kv=tsk)
    monkeypatch.setattr(jfa, "_FUSED_BWD_MAX_KV_BYTES", 0)     # the split

    def jf(qq, kk, vv):
        return jfa.flash_attention(qq, kk, vv, block_q=128, block_k=128,
                                   block_q_bwd=128, block_k_bwd=128,
                                   interpret=True, autotune="off", **kw)

    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    jdq = np.asarray(vjp(jnp.asarray(do))[0], np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = tfa.flash_attention_reference(tq, tk, tv, **tkw)
    delta = (tdo * out).sum(-1)
    dq = _emulate_dq(tq, tk, tv, tdo, lse, delta, tsq, tsk, causal,
                     d ** -0.5)
    np.testing.assert_allclose(dq.numpy(), jdq, rtol=0,
                               atol=1e-5 * float(np.abs(jdq).max()))
    if seg:                 # padding rows: dq exactly zero
        pad = (tsq < 0)[:, None, :].expand(dq.shape[:3])
        assert not bool(dq[pad].any())


def test_cpu_calls_count_no_launch():
    fwd, bwd = tfa.flash_attention, tfa.flash_attention_bwd
    names = [(fwd, "launches"), (fwd, "f32_launches"),
             (bwd, "dq_launches"), (bwd, "f32_dq_launches"),
             (bwd, "dkdv_launches"), (bwd, "f32_dkdv_launches")]
    before = [getattr(f, n) for f, n in names]
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 2, 40, 64, generator=g) for _ in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    tfa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    qr = q.clone().requires_grad_()
    tfa.flash_attention(qr, k, v, causal=True).sum().backward()
    assert [getattr(f, n) for f, n in names] == before
