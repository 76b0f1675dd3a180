"""The port's kernels on the card, held against their plain versions over
more shapes than ``chip_smoke.py`` checks.

Every test needs an NVIDIA GPU (with ``nvcc`` and ``triton``) and skips
without one. Run on the card, without the JAX test configuration::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: bf16 outputs within two bf16 ulps of the plain version plus an
absolute floor (4e-3 for flash attention, whose kernel rounds p to bf16
before the PV product; 1e-3 for paged decode, bf16 or fp8 pool, and for the
fp8 dequant-matmul, whose fp32 sums run in another order than the plain
version's); fp32 lse within 1e-3; fp32 LayerNorm outputs within 1e-5
relative; half-precision LayerNorm outputs within one ulp. The e4m3 cast on
the card is bitwise the CPU's, and the fp8 engines keep the serve path's
bitwise contracts (preempt/resume, speculative against plain decode).

Backward kernels: the flash backward rounds p and ds to bf16 before its
products (as the TPU kernel does) where the plain version (the JAX
``_bwd_math``) keeps fp32, and sums dq with atomics in a varying order, so
its gradients are held within two bf16 ulps plus 2 % of the largest
gradient, and within 1 % in relative norm. The LayerNorm backward computes
in fp32 like its plain version: dx within two ulps of its dtype plus 1e-5
of the largest, dgamma/dbeta (fp32 sums over rows in another order) within
1e-4 of the largest plus one ulp of their dtype. The LM-head CE statistics
are fp32 sums of the same exact products in another order: within 1e-4
relative; its gradients round the same g tile to bf16 (a logit an fp32 ulp
apart can flip one rounding), held like the flash gradients. The flash
backward's two-kernel split (dk/dv, then dq without atomics; on the wgmma
route dq first, folding in delta) rounds at the same points as the single
pass and is held the same way, bitwise on a rerun; the wgmma route's
register-A product alone is held within 1e-5 of ``torch.matmul``. The softmax
cross entropy's fp32 losses are within 1e-5 relative of the plain twin's,
its gradients within two ulps of the logits' dtype plus 1e-6 of the
largest. The fused multi-tensor optimizer update (B13) is bitwise its
plain version in every mode, at ragged sizes and under a set skip flag.

The wgmma/TMA forward and single pass (``csrc/flash_fwd_sm90.cu``,
``flash_bwd_fused_sm90``) are held at the same tolerances, over ragged s,
sq != sk, segment padding, d 64/128 and padded, bf16 and fp16; the forward
and the single pass's dk, dv bitwise on a rerun, its dq not (bulk
reductions into an fp32 accumulator in a varying order).

The shapes and dtypes ROADMAP §C records as repaired: fp16 flash, paged
decode and LM-head CE are held like bf16 (two bf16 ulps bound two fp16
ulps); fp32 kernels round nothing below fp32, so their outputs are held
within 1e-5 and their gradients within 1e-4 of the largest value and in
relative norm (summation order, ``__expf``, the dq atomics). The per-op
probe (B14) is bitwise its plain loop for mul, max, where and
iota_cmp_where and within 2 fp32 ulps for exp and exp2; the fused
bottleneck (B15) is within two bf16 ulps plus 2^-5 of its plain version
(h1 and h2 are rounded to bf16 on both sides, so a flipped rounding of one
moves the outputs it feeds) and within the proto's 0.15 of the cuDNN
composition.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.amp import fp8
from apex_tpu_torch.ops import flash_attention as fa
from apex_tpu_torch.ops import fused_ce as xe
from apex_tpu_torch.ops import fp8_matmul as mm
from apex_tpu_torch.ops import layer_norm as ln
from apex_tpu_torch.ops import lm_head_ce as ce

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, ref, floor, ulps=2):
    got, ref = got.float(), ref.float()
    tol = ref.abs() * ulps * 2.0 ** -7 + floor
    assert bool(((got - ref).abs() <= tol).all()), \
        float((got - ref).abs().max())


def _rand(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)


@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg", [
    (1, 1, 1, 1, 64, True, False),
    (2, 3, 65, 65, 64, True, True),
    (1, 2, 17, 200, 128, True, False),       # sq < sk: end-aligned causal
    (1, 2, 130, 90, 64, True, True),         # sq > sk: rows with no key
    (3, 2, 100, 100, 32, False, True),
    (1, 4, 512, 512, 64, True, True),
])
def test_flash_fwd_matches_plain(gen, b, h, sq, sk, d, causal, seg):
    q, k, v = _rand(gen, b, h, sq, d), _rand(gen, b, h, sk, d), \
        _rand(gen, b, h, sk, d)
    sid_q = sid_kv = None
    if seg:
        rng = np.random.RandomState(b * sq + sk)
        sid_q = np.sort(rng.randint(-1, 3, (b, sq)), axis=1)[:, ::-1]
        sid_kv = np.sort(rng.randint(-1, 3, (b, sk)), axis=1)[:, ::-1]
        sid_q = torch.from_numpy(sid_q.copy()).int().cuda()
        sid_kv = torch.from_numpy(sid_kv.copy()).int().cuda()
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal)
    assert fa.flash_attention.launches == before + 1
    ref, ref_lse = fa.flash_attention_reference(
        q, k, v, causal=causal, segment_ids_q=sid_q, segment_ids_kv=sid_kv)
    _close(out, ref, 4e-3)
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    if seg:
        pad = (sid_q < 0)[:, None, :].expand(b, h, sq)
        assert not bool(out[pad].any())


@pytest.mark.parametrize("b,kv,g,d,page,m,seq_lens", [
    (2, 2, 1, 64, 8, 5, [0, 40]),
    (3, 2, 3, 64, 16, 4, [13, 0, 64]),
    (4, 1, 8, 128, 32, 3, [1, 31, 33, 96]),
    (2, 4, 2, 32, 256, 2, [257, 512]),
    (8, 16, 1, 64, 128, 8, [0, 1, 127, 128, 129, 300, 640, 1024]),
])
def test_paged_decode_matches_plain(gen, b, kv, g, d, page, m, seq_lens):
    num_pages = 1 + b * m
    q = _rand(gen, b, kv, g, d)
    kp, vp = _rand(gen, kv, num_pages, page, d), \
        _rand(gen, kv, num_pages, page, d)
    rng = np.random.RandomState(sum(seq_lens))
    bt = rng.permutation(np.arange(1, num_pages))[:b * m].reshape(b, m)
    bt = torch.from_numpy(bt.astype(np.int32)).cuda()
    sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    before = fa.paged_decode_attention.launches
    out = fa.paged_decode_attention(q, kp, vp, bt, sl)
    assert fa.paged_decode_attention.launches == before + 1
    ref = fa.paged_attention_reference(q, kp, vp, bt, sl)
    _close(out, ref, 1e-3)
    for i, n in enumerate(seq_lens):
        if n == 0:
            assert float(out[i].abs().max()) == 0.0


@pytest.mark.parametrize("n,h", [(1, 128), (3, 1000), (8, 1024), (512, 1024),
                                 (5, 4096)])
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16),
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32)])
def test_layer_norm_matches_plain(gen, n, h, x_dtype, out_dtype):
    x = _rand(gen, n, h, dtype=torch.float32).mul(2).add(0.5).to(x_dtype)
    w = 1 + 0.1 * _rand(gen, h, dtype=torch.float32)
    b = 0.1 * _rand(gen, h, dtype=torch.float32)
    before = ln.fused_layer_norm_affine.launches
    y = ln.fused_layer_norm_affine(x, w, b, (h,), 1e-5, out_dtype)
    assert ln.fused_layer_norm_affine.launches == before + 1
    ref = ln.fused_layer_norm_affine_reference(x, w, b, (h,), 1e-5,
                                               out_dtype)
    assert y.dtype == out_dtype
    if out_dtype == torch.float32:
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
    else:
        ulp = 2.0 ** -7 if out_dtype == torch.bfloat16 else 2.0 ** -10
        assert bool(((y.float() - ref.float()).abs()
                     <= ref.float().abs() * ulp + 1e-6).all())


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    q = _rand(gen, 1, 2, 16, 64)
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        fa.flash_attention_fwd(q.double(), q.double(), q.double())
    # mixed operand dtypes run, in q's dtype (ROADMAP §C, repaired)
    assert fa.flash_attention_fwd(q, q.float(), q)[0].dtype == q.dtype
    qt = _rand(gen, 1, 16, 2, 64).transpose(1, 2)      # [1, 2, 16, 64]
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(qt, qt, qt)
    with pytest.raises(ValueError, match="head dim"):
        qq = _rand(gen, 1, 2, 16, 520)
        fa.flash_attention_fwd(qq, qq, qq)
    with pytest.raises(NotImplementedError, match="bias"):
        fa.flash_attention(q, q, q, bias=torch.zeros(1, 2, 16, 16,
                                                     device="cuda"))
    qp = _rand(gen, 2, 2, 1, 64)
    pages = _rand(gen, 2, 4, 8, 64)
    bt = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
    sl = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="float8_e4m3fn"):   # bf16 pages
        fa.paged_decode_attention(qp, pages, pages, bt, sl,
                                  k_scales=torch.ones(2, 4, device="cuda"),
                                  v_scales=torch.ones(2, 4, device="cuda"))
    pages8 = pages.to(torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="num_pages"):
        fa.paged_decode_attention(qp, pages8, pages8, bt, sl,
                                  k_scales=torch.ones(2, 5, device="cuda"),
                                  v_scales=torch.ones(2, 5, device="cuda"))
    w8 = _rand(gen, 64, 32).to(torch.float8_e4m3fn)
    one = torch.ones((), device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        mm.fp8_dequant_matmul(_rand(gen, 8, 64).float(), w8, one)
    with pytest.raises(ValueError, match="one fp32 value"):
        mm.fp8_dequant_matmul(_rand(gen, 8, 64), w8, one.double())
    with pytest.raises(ValueError, match="int32"):
        fa.paged_decode_attention(qp, pages, pages, bt.long(), sl)
    # a pool of another dtype than q's runs (ROADMAP §C, repaired); k and v
    # pages of two dtypes do not
    assert fa.paged_decode_attention(qp.half(), pages, pages, bt,
                                     sl).dtype == torch.float16
    with pytest.raises(ValueError, match="v_pages has dtype"):
        fa.paged_decode_attention(qp, pages, pages.half(), bt, sl)
    with pytest.raises(ValueError, match="head dim"):
        qp5, p5 = _rand(gen, 2, 2, 1, 520), _rand(gen, 2, 4, 8, 520)
        fa.paged_decode_attention(qp5, p5, p5, bt, sl)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        ln.fused_layer_norm_affine(q, torch.ones(64, device="cuda").double(),
                                   torch.zeros(64, device="cuda"), (64,),
                                   out_dtype=torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, q, q, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd(q, q, q, o, lse, qt, causal=True)
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        fa.flash_attention_bwd(q.double(), q.double(), q.double(),
                               o.double(), lse, o.double())
    # the fp32 backward past d 128 runs (ROADMAP §C, repaired)
    q200 = _rand(gen, 1, 2, 16, 200, dtype=torch.float32)
    o200, lse200 = fa.flash_attention_fwd(q200, q200, q200)
    assert all(g.dtype == torch.float32 for g in fa.flash_attention_bwd(
        q200, q200, q200, o200, lse200, o200))
    x = _rand(gen, 8, 256)
    e = _rand(gen, 100, 256)
    t = torch.zeros(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        ce.lm_head_ce_fwd(x.double(), e.double(), t)
    with pytest.raises(ValueError, match="dtype"):
        ce.lm_head_ce_fwd(x, e.float(), t)
    with pytest.raises(ValueError, match="int32"):
        ce.lm_head_ce_fwd(x, e, t.long())
    with pytest.raises(ValueError, match="contiguous"):
        ce.lm_head_ce_fwd(_rand(gen, 256, 8).t(), e, t)
    m = torch.zeros(8, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        ce.lm_head_ce_bwd(x, e, t, m.half(), m + 1, m)
    dy = _rand(gen, 4, 64)
    with pytest.raises(ValueError, match="contiguous"):
        ln.layer_norm_bwd(_rand(gen, 64, 4).t(), torch.ones(64,
                                                            device="cuda"),
                          dy, (64,))


def _close_grad(got, ref, name):
    """Two bf16 ulps plus 2 % of the largest |ref|, and 1 % in norm (the
    module docstring gives the reason)."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    floor = 0.02 * float(ref.abs().max()) + 1e-6
    assert bool((diff <= ref.abs() * 2 * 2.0 ** -7 + floor).all()), \
        (name, float(diff.max()), floor)
    rel = float(diff.norm() / ref.norm().clamp_min(1e-30))
    assert rel <= 1e-2, (name, rel)


@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg", [
    (1, 1, 1, 1, 64, True, False),
    (2, 3, 65, 65, 64, True, True),
    (1, 2, 17, 200, 128, True, False),       # sq < sk: end-aligned causal
    (1, 2, 130, 90, 64, True, True),         # sq > sk: rows with no key
    (3, 2, 100, 100, 32, False, True),
    (2, 4, 256, 256, 64, True, False),
    (1, 2, 200, 200, 128, False, False),
])
def test_flash_bwd_matches_plain(gen, b, h, sq, sk, d, causal, seg):
    q, k, v = _rand(gen, b, h, sq, d), _rand(gen, b, h, sk, d), \
        _rand(gen, b, h, sk, d)
    do = _rand(gen, b, h, sq, d)
    sid_q = sid_kv = None
    if seg:
        rng = np.random.RandomState(b * sq + sk)
        sid_q = np.sort(rng.randint(-1, 3, (b, sq)), axis=1)[:, ::-1]
        sid_kv = np.sort(rng.randint(-1, 3, (b, sk)), axis=1)[:, ::-1]
        sid_q = torch.from_numpy(sid_q.copy()).int().cuda()
        sid_kv = torch.from_numpy(sid_kv.copy()).int().cuda()
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal)
    before = fa.flash_attention_bwd.launches
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, sid_q, sid_kv,
                                        causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    rq, rk, rv = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=causal, segment_ids_q=sid_q,
        segment_ids_kv=sid_kv)
    for name, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        _close_grad(got, ref, name)
    if seg:
        pad = (sid_q < 0)[:, None, :].expand(b, h, sq)
        assert not bool(dq[pad].any())


def test_flash_autograd_runs_both_kernels(gen):
    q, k, v = (_rand(gen, 2, 2, 64, 64).requires_grad_() for _ in range(3))
    f0, b0 = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    out = fa.flash_attention(q, k, v, causal=True)
    out.float().square().sum().backward()
    assert fa.flash_attention.launches == f0 + 1
    assert fa.flash_attention_bwd.launches == b0 + 1
    assert q.grad is not None and k.grad.dtype == torch.bfloat16


_BF, _F16 = torch.bfloat16, torch.float16


@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg,dtype", [
    (1, 1, 1, 1, 64, True, False, _BF),
    (2, 3, 65, 65, 64, True, True, _BF),
    (1, 2, 17, 200, 128, True, False, _BF),  # sq < sk: end-aligned causal
    (1, 2, 130, 90, 64, True, True, _BF),    # sq > sk: rows with no key
    (3, 2, 100, 100, 32, False, True, _BF),  # d 32: flash_bwd.cu's route
    (1, 2, 2049, 2049, 64, True, True, _BF),  # past the gate: routed split
    # the wgmma route's tile edges: 127/129 rows about its 64- and 128-row
    # tiles, 4097 one past the s4096 cell, sq != sk both ways, d 64 and
    # 128, fp16, segment ids with padding
    (1, 2, 127, 127, 64, True, False, _BF),
    (1, 2, 129, 129, 128, True, True, _BF),
    (1, 2, 4097, 4097, 64, True, False, _BF),
    (1, 1, 4097, 4097, 128, True, True, _F16),
    (1, 2, 129, 300, 64, True, True, _BF),
    (1, 2, 300, 129, 128, True, False, _BF),
    (2, 2, 200, 77, 64, False, True, _F16),
    (1, 3, 77, 200, 128, False, False, _F16),
    (2, 2, 127, 129, 64, True, True, _F16),
    (1, 2, 129, 127, 128, True, True, _F16),
])
def test_flash_bwd_split_matches_plain(gen, b, h, sq, sk, d, causal, seg,
                                       dtype):
    """The dk/dv and dq kernels (the split is forced below the gate) against
    the plain backward, held like the single pass; the wgmma route's
    counters move exactly where :func:`split_route` sends the shape."""
    q, k, v = _rand(gen, b, h, sq, d, dtype=dtype), \
        _rand(gen, b, h, sk, d, dtype=dtype), _rand(gen, b, h, sk, d,
                                                     dtype=dtype)
    do = _rand(gen, b, h, sq, d, dtype=dtype)
    sid_q = sid_kv = None
    if seg:
        rng = np.random.RandomState(b * sq + sk)
        sid_q = np.sort(rng.randint(-1, 3, (b, sq)), axis=1)[:, ::-1]
        sid_kv = np.sort(rng.randint(-1, 3, (b, sk)), axis=1)[:, ::-1]
        sid_q = torch.from_numpy(sid_q.copy()).int().cuda()
        sid_kv = torch.from_numpy(sid_kv.copy()).int().cuda()
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal)
    f = fa.flash_attention_bwd
    counts = (f.launches, f.dkdv_launches, f.dq_launches,
              f.wgmma_dkdv_launches, f.wgmma_dq_launches)
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv,
                                    causal, d ** -0.5, split=True)
    torch.cuda.synchronize()
    wgmma = int(fa.split_route(dtype, fa.kernel_head_dim(d))
                == "flash_bwd_sm90")
    assert (f.launches, f.dkdv_launches, f.dq_launches,
            f.wgmma_dkdv_launches, f.wgmma_dq_launches) == (
        counts[0], counts[1] + 1, counts[2] + 1, counts[3] + wgmma,
        counts[4] + wgmma)
    rq, rk, rv = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=causal, segment_ids_q=sid_q,
        segment_ids_kv=sid_kv)
    for name, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert got.dtype == dtype and got.shape == ref.shape
        _close_grad(got, ref, name)
    if seg:
        pad = (sid_q < 0)[:, None, :].expand(b, h, sq)
        assert not bool(dq[pad].any())


@pytest.mark.parametrize("d,dtype", [(64, _BF), (128, _F16), (80, _BF)])
@pytest.mark.parametrize("seg", [False, True])
def test_flash_bwd_split_wgmma_route_is_bitwise_on_a_rerun(gen, d, dtype,
                                                          seg):
    """No atomics on the wgmma route: two runs give the same dq, dk, dv
    bits (d 80 runs zero-padded to 128), and its kernels hold against
    their own plain versions: dq with the delta it folds in (fp32 sums of
    the same products, 1e-5 of the largest), dk/dv from that delta."""
    b, h, s = 2, 3, 777
    q, k, v, do = (_rand(gen, b, h, s, d, dtype=dtype) for _ in range(4))
    sid = None
    if seg:
        sid = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        sid[:, 300:] = 1
        sid[1, 700:] = -1
    out, lse = fa.flash_attention_fwd(q, k, v, sid, None, True)
    w0 = fa.flash_attention_bwd.wgmma_dq_launches
    one = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid, None, True,
                             d ** -0.5, split=True)
    two = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid, None, True,
                             d ** -0.5, split=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.wgmma_dq_launches == w0 + 2
    for x, y in zip(one, two):
        assert torch.equal(x, y)
    if d in (64, 128):
        delta = torch.empty(b, h, s, dtype=torch.float32, device="cuda")
        args = (q, k, v, do, lse, delta, sid, sid, True, d ** -0.5, 0x2A)
        dq = fa._flash_dq_cuda(*args, out=out)
        dk, dv = fa._flash_dkdv_cuda(*args)
        rdq, rdelta = fa.flash_bwd_dq_reference(
            q, k, v, out, lse, do, causal=True, segment_ids_q=sid)
        rdk, rdv = fa.flash_bwd_dkdv_reference(
            q, k, v, lse, delta, do, causal=True, segment_ids_q=sid)
        torch.cuda.synchronize()
        assert float((delta - rdelta).abs().max()) <= \
            1e-5 * float(rdelta.abs().max())
        for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk),
                               ("dv", dv, rdv)):
            _close_grad(got, ref, name)
        assert torch.equal(dq, one[0])


_WGMMA_CASES = [
    # ragged s about the 64/128-row tiles, sq < sk and sq > sk causal,
    # segment ids with padding rows, d 64, 128 and a padded d (80 -> 128,
    # 40 -> 64), bf16 and fp16
    (1, 1, 1, 1, 64, True, False, _BF),
    (2, 3, 65, 65, 64, True, True, _BF),
    (1, 2, 127, 127, 64, True, False, _F16),
    (1, 2, 129, 129, 128, True, True, _BF),
    (1, 2, 17, 200, 128, True, False, _BF),   # sq < sk: end-aligned causal
    (1, 2, 130, 90, 64, True, True, _BF),     # sq > sk: rows with no key
    (1, 2, 300, 129, 128, True, False, _F16),
    (2, 2, 200, 77, 64, False, True, _F16),
    (2, 2, 257, 257, 80, True, True, _BF),
    (1, 3, 333, 333, 40, True, False, _F16),
    (2, 4, 512, 512, 64, True, True, _BF),
    (1, 2, 777, 777, 128, True, True, _F16),
]


def _wgmma_inputs(gen, b, h, sq, sk, d, seg, dtype):
    q, k, v, do = (_rand(gen, b, h, s_, d, dtype=dtype)
                   for s_ in (sq, sk, sk, sq))
    sid_q = sid_kv = None
    if seg:
        rng = np.random.RandomState(b * sq + sk)
        sid_q = np.sort(rng.randint(-1, 3, (b, sq)), axis=1)[:, ::-1]
        sid_kv = np.sort(rng.randint(-1, 3, (b, sk)), axis=1)[:, ::-1]
        sid_q = torch.from_numpy(sid_q.copy()).int().cuda()
        sid_kv = torch.from_numpy(sid_kv.copy()).int().cuda()
    return q, k, v, do, sid_q, sid_kv


@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg,dtype", _WGMMA_CASES)
@pytest.mark.parametrize("rows", [64, 128])
def test_flash_fwd_wgmma_route_matches_plain(gen, b, h, sq, sk, d, causal,
                                             seg, dtype, rows):
    """The wgmma forward (csrc/flash_fwd_sm90.cu) at both block heights
    against the plain version (two bf16 ulps + 4e-3, lse 1e-3); padding
    rows exactly zero; the same bits on a rerun (no atomics); one launch
    on the wgmma counter."""
    q, k, v, _, sid_q, sid_kv = _wgmma_inputs(gen, b, h, sq, sk, d, seg,
                                              dtype)
    f = fa.flash_attention
    n0 = (f.launches, f.wgmma_launches)
    out, lse = fa._flash_fwd_cuda(q, k, v, sid_q, sid_kv, causal, d ** -0.5,
                                  block_rows=rows)
    again = fa._flash_fwd_cuda(q, k, v, sid_q, sid_kv, causal, d ** -0.5,
                               block_rows=rows)
    torch.cuda.synchronize()
    assert (f.launches, f.wgmma_launches) == (n0[0] + 2, n0[1] + 2)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = fa.flash_attention_reference(
        q, k, v, causal=causal, segment_ids_q=sid_q, segment_ids_kv=sid_kv)
    assert out.dtype == dtype
    _close(out, ref, 4e-3)
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    if seg:
        pad = (sid_q < 0)[:, None, :].expand(b, h, sq)
        assert not bool(out[pad].any())


@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg,dtype", _WGMMA_CASES)
def test_flash_bwd_fused_wgmma_route_matches_plain(gen, b, h, sq, sk, d,
                                                   causal, seg, dtype):
    """The wgmma single pass (flash_bwd_fused_sm90) against the plain
    backward, held like the other backward kernels; dq, dk and dv are the
    same bits on a rerun (dk and dv written once by the block that owns
    its keys, dq's partials added in a fixed order of key blocks).
    Padding rows get exactly zero dq."""
    q, k, v, do, sid_q, sid_kv = _wgmma_inputs(gen, b, h, sq, sk, d, seg,
                                               dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal)
    f = fa.flash_attention_bwd
    n0 = (f.launches, f.wgmma_launches, f.dkdv_launches)
    one = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                             d ** -0.5, split=False)
    two = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                             d ** -0.5, split=False)
    torch.cuda.synchronize()
    assert (f.launches, f.wgmma_launches, f.dkdv_launches) == (
        n0[0] + 2, n0[1] + 2, n0[2])
    assert all(torch.equal(a, b_) for a, b_ in zip(one, two))
    ref = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=causal, segment_ids_q=sid_q,
        segment_ids_kv=sid_kv)
    for name, got, r in zip(("dq", "dk", "dv"), one, ref):
        assert got.dtype == dtype and got.shape == r.shape
        _close_grad(got, r, name)
    if seg:
        pad = (sid_q < 0)[:, None, :].expand(b, h, sq)
        assert not bool(one[0][pad].any())


@pytest.mark.parametrize("dtype,d,sm90", [
    (_BF, 64, True), (_F16, 128, True), (_BF, 256, False),
    (torch.float32, 64, False), (torch.float32, 128, False),
    (_F16, 32, False)])
@pytest.mark.parametrize("sq,sk,causal", [(1024, 1024, True),
                                          (300, 700, True), (700, 300, True),
                                          (257, 513, False)])
def test_flash_bwd_single_pass_dq_is_bitwise_on_a_rerun_and_alone(
        gen, dtype, d, sm90, sq, sk, causal):
    """The single pass on both routes (csrc/turns.cuh): dq, dk and dv the
    same bits on a rerun, and the first batch's the same bits run alone
    (each query tile's dq summed in an order of its own key blocks,
    whatever else shares the grid); within the plain version's limits."""
    b, h = 3, 4
    q = _rand(gen, b, h, sq, d, dtype=dtype)
    k, v = (_rand(gen, b, h, sk, d, dtype=dtype) for _ in range(2))
    do = _rand(gen, b, h, sq, d, dtype=dtype)
    assert fa.sm90_route(dtype, fa.kernel_head_dim(d)) == sm90
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)

    def run(sl):
        return fa._flash_bwd_cuda(q[sl], k[sl], v[sl], out[sl], lse[sl],
                                  do[sl], None, None, causal, d ** -0.5,
                                  split=False)

    one, two = run(slice(None)), run(slice(None))
    first = run(slice(0, 1))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(one, two))
    assert all(torch.equal(a, b_[:1]) for a, b_ in zip(first, one))
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=causal)
    for name, got, r in zip(("dq", "dk", "dv"), one, ref):
        if dtype == torch.float32:
            _close_fp32(got, r)
        else:
            _close_grad(got, r, name)


def test_gpt_autograd_runs_the_wgmma_flash_kernels(gen):
    """A GPT at head dim 64 (2 layers, h256, 4 heads) at b8 s1024 in bf16:
    every flash launch of its forward and backward takes the wgmma route,
    and its loss and gradients hold against the plain versions as the
    train step's are held in chip_smoke.py."""
    from apex_tpu_torch.models.gpt import GPT, GPTConfig
    cfg = GPTConfig(vocab_size=512, max_seq_len=1024, hidden_size=256,
                    num_layers=2, num_heads=4, dtype=torch.bfloat16)
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0))
    ids = torch.randint(0, 512, (8, 1024), generator=gen, device="cuda")
    labels = torch.roll(ids, -1, 1)
    params = [p for _, p in model.named_parameters()]
    f, b = fa.flash_attention, fa.flash_attention_bwd
    n0 = (f.launches, f.wgmma_launches, b.launches, b.wgmma_launches)
    loss = model.loss(ids, labels)
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    assert (f.launches, f.wgmma_launches, b.launches, b.wgmma_launches) == (
        n0[0] + 2, n0[1] + 2, n0[2] + 2, n0[3] + 2)
    ref_loss = model.loss(ids, labels, reference=True)
    refs = torch.autograd.grad(ref_loss, params)
    assert abs(float(loss) - float(ref_loss)) <= 1e-3 * float(ref_loss)
    for g, r in zip(grads, refs):
        rel = float((g.float() - r.float()).norm()
                    / r.float().norm().clamp_min(1e-30))
        assert rel <= 3e-2, rel


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n,k", [(64, 64), (64, 128), (128, 64),
                                 (128, 128)])
@pytest.mark.parametrize("b_mn", [False, True])
def test_wgmma_register_a_product_matches_matmul(gen, dtype, n, k, b_mn):
    """The register-A product of csrc/wgmma_attn.cuh alone (A in the
    m64k16 register fragments, B K-major or MN-major through the
    transpose bit, loaded by the 3-D TMA map): fp32 sums of exact products
    within 1e-5 of the largest |C|."""
    A = _rand(gen, 64, k, dtype=dtype)
    B = _rand(gen, k, n, dtype=dtype)
    ref = A.float() @ B.float()
    c = fa.wgmma_rs_probe(A, B if b_mn else B.t().contiguous(), b_mn)
    assert c.shape == (64, n) and c.dtype == torch.float32
    assert float((c - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("s,split", [(2048, False), (2049, True)])
def test_flash_autograd_routes_at_the_gate(gen, s, split):
    q, k, v = (_rand(gen, 1, 2, s, 64).requires_grad_() for _ in range(3))
    counts = (fa.flash_attention_bwd.launches,
              fa.flash_attention_bwd.dkdv_launches,
              fa.flash_attention_bwd.dq_launches)
    fa.flash_attention(q, k, v, causal=True).float().square().sum() \
        .backward()
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd.launches - counts[0],
            fa.flash_attention_bwd.dkdv_launches - counts[1],
            fa.flash_attention_bwd.dq_launches - counts[2]) == (
        (0, 1, 1) if split else (1, 0, 0))


@pytest.mark.parametrize("n,V,dtype", [
    (256, 1000, torch.float32),              # the ResNet-50 head
    (37, 1000, torch.bfloat16),
    (1, 5, torch.float32),
    (300, 32768, torch.bfloat16),            # the GPT vocabulary
    (17, 5000, torch.float16),
])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("padding_idx", [None, 0])
def test_xentropy_matches_plain(gen, n, V, dtype, smoothing, padding_idx):
    """The forward and backward kernels through the autograd function
    against the plain twin: fp32 losses within 1e-5 relative (sums and
    exponentials in another order), gradients within two ulps of the
    logits' dtype plus 1e-6 of the largest."""
    x = (3 * _rand(gen, n, V, dtype=torch.float32)).to(dtype)
    y = torch.randint(0, V, (n,), generator=gen, device="cuda")
    y[::7] = 0
    dl = torch.rand(n, generator=gen, device="cuda")
    counts = (xe.softmax_cross_entropy_with_smoothing.launches,
              xe.softmax_cross_entropy_with_smoothing.bwd_launches)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    la = xe.softmax_cross_entropy_with_smoothing(xa, y, smoothing,
                                                 padding_idx)
    ga, = torch.autograd.grad(la, xa, dl)
    torch.cuda.synchronize()
    assert (xe.softmax_cross_entropy_with_smoothing.launches,
            xe.softmax_cross_entropy_with_smoothing.bwd_launches) == (
        counts[0] + 1, counts[1] + 1)
    lb = xe.softmax_cross_entropy_reference(xb, y, smoothing, padding_idx)
    gb, = torch.autograd.grad(lb, xb, dl)
    assert la.dtype == torch.float32 and ga.dtype == dtype
    torch.testing.assert_close(la, lb, rtol=1e-5, atol=0)
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
           torch.float32: 2.0 ** -22}[dtype]
    d = (ga.float() - gb.float()).abs()
    assert bool((d <= gb.float().abs() * 2 * ulp
                 + 1e-6 * float(gb.float().abs().max()) + 1e-12).all()), \
        float(d.max())
    if padding_idx is not None:
        assert not bool(la[::7].any()) and not bool(ga[::7].any())


def test_xentropy_kernels_reject_what_they_do_not_take(gen):
    x = _rand(gen, 8, 16, dtype=torch.float32)
    y = torch.zeros(8, dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        xe.softmax_cross_entropy_with_smoothing(x.t(), y[:16].repeat(2))
    with pytest.raises(ValueError, match="logits dtype"):
        xe._xent_fwd_cuda(x.double(), y.int(), 0.0)
    with pytest.raises(ValueError, match="int32"):
        xe._xent_fwd_cuda(x, y, 0.0)


@pytest.mark.parametrize("n,h", [(1, 128), (3, 1000), (8192, 1024),
                                 (5, 4096), (700, 768)])
@pytest.mark.parametrize("x_dtype,p_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float16, torch.float32), (torch.float32, torch.float32)])
def test_layer_norm_bwd_matches_plain(gen, n, h, x_dtype, p_dtype):
    x = _rand(gen, n, h, dtype=torch.float32).mul(2).add(0.5).to(x_dtype)
    w = (1 + 0.1 * _rand(gen, h, dtype=torch.float32)).to(p_dtype)
    dy = _rand(gen, n, h, dtype=torch.float32).to(x_dtype)
    before = ln.layer_norm_bwd.launches
    dx, dw, db = ln.layer_norm_bwd(x, w, dy, (h,), 1e-5)
    torch.cuda.synchronize()
    assert ln.layer_norm_bwd.launches == before + 1
    rx, rw, rb = ln.layer_norm_bwd_reference(x, w, dy, (h,), 1e-5)
    assert dx.dtype == x_dtype and dw.dtype == db.dtype == p_dtype
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
           torch.float32: 2.0 ** -22}
    d = (dx.float() - rx.float()).abs()
    assert bool((d <= rx.float().abs() * 2 * ulp[x_dtype]
                 + 1e-5 * float(rx.float().abs().max()) + 1e-6).all()), \
        float(d.max())
    for got, ref in ((dw, rw), (db, rb)):
        d = (got.float() - ref.float()).abs()
        assert bool((d <= ref.float().abs() * ulp[p_dtype]
                     + 1e-4 * float(ref.float().abs().max()) + 1e-6
                     ).all()), float(d.max())


def test_layer_norm_autograd_runs_both_kernels(gen):
    x = _rand(gen, 16, 256).requires_grad_()
    w = torch.ones(256, device="cuda", dtype=torch.bfloat16,
                   requires_grad=True)
    b = torch.zeros(256, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    f0, b0 = ln.fused_layer_norm_affine.launches, ln.layer_norm_bwd.launches
    ln.fused_layer_norm_affine(x, w, b, (256,)).float().sum().backward()
    assert ln.fused_layer_norm_affine.launches == f0 + 1
    assert ln.layer_norm_bwd.launches == b0 + 1
    assert w.grad.dtype == torch.bfloat16 and x.grad.shape == x.shape


_CE_SHAPES = [(100, 1000, 256, 0.0), (64, 1041, 1024, 0.1),
              (33, 300, 128, 0.0), (257, 2048, 512, 0.1),
              (1, 40, 768, 0.0)]


@pytest.mark.parametrize("n,V,h,ls", _CE_SHAPES + [(5, 70, 1536, 0.1)])
def test_lm_head_ce_fwd_matches_plain(gen, n, V, h, ls):
    x = _rand(gen, n, h)
    e = _rand(gen, V, h).mul(0.1)
    tgt = torch.from_numpy(np.random.RandomState(n).randint(
        -1, V, n).astype(np.int32)).cuda()
    before = ce.lm_head_ce_fwd.launches
    got = ce.lm_head_ce_fwd(x, e, tgt, ls > 0)
    torch.cuda.synchronize()
    assert ce.lm_head_ce_fwd.launches == before + 1
    ref = ce.lm_head_ce_fwd_reference(x, e, tgt, ls > 0)
    for name, a, r in zip(("m", "l", "pred", "ssum"), got, ref):
        if r is None:
            assert a is None
            continue
        scale = float(r.abs().max()) + 1.0
        assert float((a - r).abs().max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("n,V,h,ls", _CE_SHAPES)
def test_lm_head_ce_bwd_matches_plain(gen, n, V, h, ls):
    x = _rand(gen, n, h)
    e = _rand(gen, V, h).mul(0.1)
    tgt = torch.from_numpy(np.random.RandomState(n).randint(
        0, V, n).astype(np.int32)).cuda()
    m, l, _, _ = ce.lm_head_ce_fwd_reference(x, e, tgt)
    dl = torch.full((n,), 1.0 / n, device="cuda")
    before = ce.lm_head_ce_bwd.launches
    dx, de = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl, ls)
    torch.cuda.synchronize()
    assert ce.lm_head_ce_bwd.launches == before + 1
    rx, re = ce.lm_head_ce_bwd_reference(x, e, tgt, m, l, dl, ls)
    _close_grad(dx, rx, "dx")
    _close_grad(de, re, "dE")


def test_lm_head_ce_autograd_runs_both_kernels(gen):
    x = _rand(gen, 2, 16, 256).requires_grad_()
    e = _rand(gen, 500, 256).mul(0.1).requires_grad_()
    t = torch.randint(0, 500, (2, 16), device="cuda")
    f0, b0 = ce.lm_head_ce_fwd.launches, ce.lm_head_ce_bwd.launches
    loss = ce.fused_lm_head_cross_entropy(x, e, t)
    assert loss.shape == (2, 16) and loss.dtype == torch.float32
    loss.mean().backward()
    assert ce.lm_head_ce_fwd.launches == f0 + 1
    assert ce.lm_head_ce_bwd.launches == b0 + 1
    assert e.grad.dtype == torch.bfloat16 and x.grad.shape == x.shape


def test_engine_preempt_resume_bit_exact_on_the_card(gen):
    """The replay contract holds through the kernels: a preempted
    sequence's logits rows are bit-identical to an uninterrupted run."""
    from apex_tpu_torch.models.gpt import GPT, GPTConfig
    from apex_tpu_torch.serve import ServeEngine
    cfg = GPTConfig(vocab_size=256, max_seq_len=128, hidden_size=128,
                    num_layers=2, num_heads=2, dtype=torch.bfloat16)
    params = GPT.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = [[5, 9, 17, 3, 40, 22, 8], [11, 2, 33, 60, 7, 7, 1, 90, 4]]

    def run(preempt_at=None):
        eng = ServeEngine(cfg, params, num_pages=32, max_seq_len=64,
                          max_prompt_len=16, page_size=8, max_batch=2,
                          record_logits=True)
        ids = [eng.add_request(p, 12) for p in prompts]
        steps = 0
        while eng.sched.has_work:
            eng.step()
            steps += 1
            if steps == preempt_at:
                eng.preempt(ids[0])
        return eng, ids

    a, ids = run()
    b, _ = run(preempt_at=4)
    assert b.seqs[ids[0]].n_preemptions == 1
    for sid in ids:
        assert a.seqs[sid].tokens == b.seqs[sid].tokens
        assert set(a.logits_log[sid]) == set(b.logits_log[sid])
        for pos in a.logits_log[sid]:
            assert np.array_equal(a.logits_log[sid][pos],
                                  b.logits_log[sid][pos]), (sid, pos)


@pytest.mark.parametrize("m", [8, 512])
@pytest.mark.parametrize("K,N", [(1024, 3072), (1024, 1024), (1024, 4096),
                                 (4096, 1024)])
def test_fp8_matmul_matches_plain(gen, m, K, N):
    x = _rand(gen, m, K)
    q, scale = mm.quantize_weight(_rand(gen, K, N, dtype=torch.float32)
                                  * K ** -0.5)
    before = mm.fp8_dequant_matmul.launches
    y = mm.fp8_dequant_matmul(x, q, scale)
    assert mm.fp8_dequant_matmul.launches == before + 1
    ref = mm.fp8_dequant_matmul_reference(x, q, scale)
    assert y.dtype == torch.bfloat16 and y.shape == (m, N)
    _close(y, ref, 1e-3)
    # rows never mix: a row's bits do not depend on the rows beside it
    # (the decode regime serves every m <= 8 through one sum order)
    if m == 8:
        y1 = mm.fp8_dequant_matmul(x[3:4].contiguous(), q, scale)
        assert torch.equal(y1[0], y[3])


@pytest.mark.parametrize("b,kv,g,d,page,m,seq_lens", [
    (3, 2, 3, 64, 16, 4, [13, 0, 64]),
    (8, 16, 1, 64, 128, 8, [0, 1, 127, 128, 129, 300, 640, 1024]),
])
def test_fp8_paged_decode_matches_plain(gen, b, kv, g, d, page, m, seq_lens):
    num_pages = 1 + b * m

    def pool():
        x = _rand(gen, kv, num_pages, page, d, dtype=torch.float32)
        s = fp8.compute_scale(x.abs().amax(dim=(2, 3)), fp8.E4M3_MAX, 2.0)
        return fp8.quantize(x, s[..., None, None], fp8.E4M3), s

    q = _rand(gen, b, kv, g, d)
    (kp, ks), (vp, vs) = pool(), pool()
    rng = np.random.RandomState(sum(seq_lens))
    bt = rng.permutation(np.arange(1, num_pages))[:b * m].reshape(b, m)
    bt = torch.from_numpy(bt.astype(np.int32)).cuda()
    sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    b16, b8 = fa.paged_decode_attention.launches, \
        fa.paged_decode_attention.fp8_launches
    out = fa.paged_decode_attention(q, kp, vp, bt, sl, k_scales=ks,
                                    v_scales=vs)
    assert fa.paged_decode_attention.fp8_launches == b8 + 1
    assert fa.paged_decode_attention.launches == b16
    ref = fa.paged_attention_reference(q, kp, vp, bt, sl, k_scales=ks,
                                       v_scales=vs)
    _close(out, ref, 1e-3)
    for i, n in enumerate(seq_lens):
        if n == 0:
            assert float(out[i].abs().max()) == 0.0


def test_e4m3_cast_on_the_card_is_the_cpus(gen):
    x = _rand(gen, 1 << 16, dtype=torch.float32) * 2.0 ** torch.randint(
        -14, 12, (1 << 16,), generator=gen, device="cuda")
    for s in (1.0, 0.37, 12.5):
        sc = torch.tensor(s, device="cuda")
        got = fp8.quantize(x, sc, fp8.E4M3).view(torch.uint8).cpu()
        want = fp8.quantize(x.cpu(), sc.cpu(), fp8.E4M3).view(torch.uint8)
        assert torch.equal(got, want)


def test_fp8_engines_on_the_card(gen):
    """fp8 weights + fp8 KV through the kernels, and speculative decoding
    over fp8 weights token- and bit-identical to plain decode."""
    from apex_tpu_torch.models.gpt import GPT, GPTConfig
    from apex_tpu_torch.serve import ServeEngine
    cfg = GPTConfig(vocab_size=256, max_seq_len=128, hidden_size=128,
                    num_layers=2, num_heads=2, dtype=torch.bfloat16)
    params = GPT.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = [[5, 9, 17, 3, 40, 22, 8], [11, 2, 33, 60, 7, 7, 1, 90, 4]]

    def run(preempt_at=None, **kw):
        eng = ServeEngine(cfg, params, num_pages=32, max_seq_len=64,
                          max_prompt_len=16, page_size=8, max_batch=4,
                          record_logits=True, fp8_weights=True, **kw)
        ids = [eng.add_request(p, 12) for p in prompts]
        steps = 0
        while eng.sched.has_work:
            eng.step()
            steps += 1
            if steps == preempt_at:
                eng.preempt(ids[0])
        return eng, ids

    def same(a, b, ids):
        for sid in ids:
            assert a.seqs[sid].tokens == b.seqs[sid].tokens
            assert set(a.logits_log[sid]) == set(b.logits_log[sid])
            for pos in a.logits_log[sid]:
                assert np.array_equal(a.logits_log[sid][pos],
                                      b.logits_log[sid][pos]), (sid, pos)

    l8 = fa.paged_decode_attention.fp8_launches
    kv, ids = run(fp8_kv=True)
    assert fa.paged_decode_attention.fp8_launches > l8
    kv_pre, _ = run(fp8_kv=True, preempt_at=4)
    assert kv_pre.seqs[ids[0]].n_preemptions == 1
    same(kv, kv_pre, ids)
    plain, _ = run()
    spec, _ = run(spec_k=3)
    assert spec.spec_rounds > 0
    same(plain, spec, ids)


# -- B13: the fused multi-tensor optimizer update --------------------------

_MTU_MODES = [
    dict(kind="adam", adam_w_mode=True, weight_decay=0.01,
         bias_correction=True),
    dict(kind="adam", adam_w_mode=False, weight_decay=0.01,
         bias_correction=True),
    dict(kind="adam", adam_w_mode=True, weight_decay=0.0,
         bias_correction=False),
    dict(kind="lamb", adam_w_mode=True, weight_decay=0.01,
         bias_correction=True, grad_averaging=True),
    dict(kind="lamb", adam_w_mode=False, weight_decay=0.01,
         bias_correction=False, grad_averaging=False),
]


def _mtu_inputs(gen, n):
    p = _rand(gen, n, dtype=torch.float32) * 0.05
    g = _rand(gen, n, dtype=torch.float32) * 0.01
    m = _rand(gen, n, dtype=torch.float32) * 1e-3
    v = (_rand(gen, n, dtype=torch.float32) * 1e-2).square()
    return p, g, m, v


@pytest.mark.parametrize("n", [1, 3, 4, 1027, 1_000_003])
@pytest.mark.parametrize("mode", range(len(_MTU_MODES)))
def test_multi_tensor_update_matches_plain_bitwise(gen, n, mode):
    from apex_tpu_torch.zero import fused_update as fu
    hyper = dict(betas=(0.9, 0.999), eps=1e-8, **_MTU_MODES[mode])
    p, g, m, v = _mtu_inputs(gen, n)
    step = torch.full((), 5, dtype=torch.int32, device="cuda")
    scal = fu.update_scalars(1e-3, step, hyper["betas"],
                             hyper["bias_correction"], "cuda")
    ref = fu.fused_shard_update_reference(
        p, g, m, v, step, lr=scal[0], corrections=(scal[1], scal[2]),
        **hyper)
    kp, km, kv = p.clone(), m.clone(), v.clone()
    counts = (fu.fused_shard_update.launches,
              fu.fused_shard_update.lamb_launches)
    got = fu.fused_shard_update(kp, g, km, kv, step, lr=1e-3, **hyper)
    torch.cuda.synchronize()
    lamb = hyper["kind"] == "lamb"
    assert (fu.fused_shard_update.launches - counts[0],
            fu.fused_shard_update.lamb_launches - counts[1]) == \
        ((0, 1) if lamb else (1, 0))
    assert got[1] is km and got[2] is kv and (got[0] is kp) != lamb
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    if lamb:
        assert torch.equal(kp, p)


@pytest.mark.parametrize("mode", range(len(_MTU_MODES)))
def test_multi_tensor_update_skip_writes_nothing(gen, mode):
    from apex_tpu_torch.zero import fused_update as fu
    hyper = dict(betas=(0.9, 0.999), eps=1e-8, **_MTU_MODES[mode])
    p, g, m, v = _mtu_inputs(gen, 4099)
    kp, km, kv = p.clone(), m.clone(), v.clone()
    skip = torch.ones((), dtype=torch.bool, device="cuda")
    out = fu.fused_shard_update(kp, g, km, kv, torch.ones(
        (), dtype=torch.int32, device="cuda"), lr=1e-3, skip=skip, **hyper)
    torch.cuda.synchronize()
    assert torch.equal(kp, p) and torch.equal(km, m) and torch.equal(kv, v)
    if hyper["kind"] == "lamb":
        assert not bool(out[0].any())


def test_multi_tensor_update_unaligned_views_and_rejects(gen):
    """A view at an odd offset takes the scalar path, bitwise the same;
    the wrapper refuses what the kernel does not take."""
    from apex_tpu_torch.zero import fused_update as fu
    hyper = dict(kind="adam", betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.01, adam_w_mode=True, bias_correction=True)
    p, g, m, v = _mtu_inputs(gen, 1001)
    step = torch.full((), 2, dtype=torch.int32, device="cuda")
    ref = fu.fused_shard_update_reference(p[1:], g[1:], m[1:], v[1:], step,
                                          lr=1e-3, **hyper)
    kp, km, kv = p.clone(), m.clone(), v.clone()
    got = fu.fused_shard_update(kp[1:], g[1:], km[1:], kv[1:], step,
                                lr=1e-3, **hyper)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    assert torch.equal(kp[:1], p[:1])
    with pytest.raises(ValueError, match="fp32"):
        fu.fused_shard_update(p.half(), g, m, v, step, lr=1e-3, **hyper)
    with pytest.raises(ValueError, match="contiguous"):
        fu.fused_shard_update(p[::2], g[::2], m[::2], v[::2], step, lr=1e-3,
                              **hyper)
    with pytest.raises(ValueError, match="skip"):
        fu.fused_shard_update(p, g, m, v, step, lr=1e-3,
                              skip=torch.tensor(True), **hyper)


def test_zero3_step_on_the_card_is_one_launch_and_skips(gen):
    """The ZeRO-3 O2 step of a small GPT: one B13 launch a step, finite
    losses; an overflowing step leaves everything bitwise unchanged."""
    from apex_tpu_torch import amp, zero
    from apex_tpu_torch.models.gpt import GPT, GPTConfig
    from apex_tpu_torch.zero import fused_update as fu
    cfg = GPTConfig(vocab_size=256, max_seq_len=64, hidden_size=128,
                    num_layers=2, num_heads=2, dtype=torch.bfloat16)
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0))
    zm, opt = amp.initialize(model, zero.ZeroOptimizer(lr=1e-3),
                             opt_level="O2", loss_scale="dynamic",
                             verbosity=0, zero=True)
    st = opt.init(zm.shard(), zm.spec)
    shards = zm.cast_params(zm.shard())
    step = zero.make_train_step(lambda m, i, l: m.loss(i, l), optimizer=opt)
    ids = torch.randint(0, 256, (2, 64), generator=gen, device="cuda")
    labels = torch.roll(ids, -1, 1)
    ss = opt._scaler.state
    n0 = fu.fused_shard_update.launches
    for _ in range(3):
        shards, st, ss, loss = step(shards, st, ss, ids, labels)
        assert bool(torch.isfinite(loss))
    assert fu.fused_shard_update.launches - n0 == 3
    before = (st.master.flat.clone(), st.m.flat.clone(), st.v.flat.clone(),
              {k: v.clone() for k, v in shards.items()})
    big = zero.make_train_step(lambda m, i, l: m.loss(i, l) * 1e38,
                               optimizer=opt)
    shards, st, ss2, _ = big(shards, st, ss, ids, labels)
    assert torch.equal(st.master.flat, before[0])
    assert torch.equal(st.m.flat, before[1])
    assert torch.equal(st.v.flat, before[2])
    assert all(torch.equal(shards[k], v) for k, v in before[3].items())
    assert int(st.step) == 3
    assert float(ss2.loss_scale) == float(ss.loss_scale) / 2


# ---------------------------------------------------------------------------
# the repaired shapes and dtypes (ROADMAP §C), B14 and B15
# ---------------------------------------------------------------------------

def _close_fp32(got, ref, tol=1e-4):
    """fp32 kernels against fp32 plain versions: no rounding below fp32 on
    either side, so only summation order, ``__expf`` and atomics: within
    ``tol`` of the largest value and in relative norm."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    assert float(diff.max()) <= tol * max(float(ref.abs().max()), 1.0)
    assert float(diff.norm() / ref.norm().clamp_min(1e-30)) <= tol


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 80), (torch.bfloat16, 96), (torch.bfloat16, 256),
    (torch.bfloat16, 24), (torch.float16, 64), (torch.float16, 96),
    (torch.float16, 256), (torch.float32, 32), (torch.float32, 64),
    (torch.float32, 80), (torch.float32, 128), (torch.float32, 256),
    (torch.bfloat16, 320), (torch.bfloat16, 512), (torch.float16, 512),
    (torch.float32, 200), (torch.float32, 512),
])
@pytest.mark.parametrize("split", [False, True])
def test_flash_other_dtypes_and_head_dims_match_plain(gen, dtype, d, split):
    b, h, sq, sk = 2, 3, 97, 130
    q = _rand(gen, b, h, sq, d, dtype=dtype)
    k, v = _rand(gen, b, h, sk, d, dtype=dtype), _rand(gen, b, h, sk, d,
                                                       dtype=dtype)
    do = _rand(gen, b, h, sq, d, dtype=dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
    assert out.dtype == dtype and out.shape == q.shape
    if dtype == torch.float32:
        _close_fp32(out, ref, 1e-5)
    else:
        _close(out, ref, 4e-3)
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, True,
                               d ** -0.5, split=split)
    refs = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                            causal=True)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == dtype and g.shape == r.shape
        if dtype == torch.float32:
            _close_fp32(g, r)
        else:
            _close_grad(g, r, name)


@pytest.mark.parametrize("dtype,g,fp8", [
    (torch.bfloat16, 16, False), (torch.bfloat16, 16, True),
    (torch.bfloat16, 12, False), (torch.float16, 16, False),
    (torch.float16, 3, True), (torch.float32, 16, False),
    (torch.float32, 9, True),
])
def test_paged_decode_groups_and_dtypes_match_plain(gen, dtype, g, fp8):
    b, kv, d, page, npg = 3, 2, 64, 16, 9
    q = _rand(gen, b, kv, g, d, dtype=dtype)
    kp = _rand(gen, kv, npg, page, d, dtype=dtype)
    vp = _rand(gen, kv, npg, page, d, dtype=dtype)
    bt = torch.tensor([[1, 2, 3, 0], [4, 0, 0, 0], [5, 6, 7, 8]],
                      dtype=torch.int32, device="cuda")
    sl = torch.tensor([40, 0, 64], dtype=torch.int32, device="cuda")
    ks = vs = None
    if fp8:
        ks = torch.rand(kv, npg, generator=gen, device="cuda") + 0.5
        vs = torch.rand(kv, npg, generator=gen, device="cuda") + 0.5
        kp = (kp.float() * ks[:, :, None, None]).to(torch.float8_e4m3fn)
        vp = (vp.float() * vs[:, :, None, None]).to(torch.float8_e4m3fn)
    before = (fa.paged_decode_attention.fp8_launches if fp8
              else fa.paged_decode_attention.launches)
    out = fa.paged_decode_attention(q, kp, vp, bt, sl, k_scales=ks,
                                    v_scales=vs)
    after = (fa.paged_decode_attention.fp8_launches if fp8
             else fa.paged_decode_attention.launches)
    assert after == before + 1 and out.dtype == dtype
    ref = fa.paged_attention_reference(q, kp, vp, bt, sl, k_scales=ks,
                                       v_scales=vs)
    if dtype == torch.float32:
        _close_fp32(out, ref, 1e-5)
    else:
        _close(out, ref, 1e-3)
    assert float(out[1].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,h", [
    (torch.bfloat16, 64), (torch.bfloat16, 100), (torch.bfloat16, 1536),
    (torch.bfloat16, 1600), (torch.bfloat16, 2048), (torch.float16, 256),
    (torch.float32, 64), (torch.float32, 1024), (torch.float32, 1600),
    (torch.float32, 2048),
])
def test_lm_head_ce_any_hidden_size_and_dtype_matches_plain(gen, dtype, h):
    n, V = 130, 3000
    x = _rand(gen, n, h, dtype=dtype)
    e = _rand(gen, V, h, dtype=dtype).mul(0.1)
    tgt = torch.from_numpy(np.random.RandomState(h).randint(
        0, V, n).astype(np.int32)).cuda()
    got = ce.lm_head_ce_fwd(x, e, tgt, True)
    ref = ce.lm_head_ce_fwd_reference(x, e, tgt, True)
    for name, a, r in zip(("m", "l", "pred", "ssum"), got, ref):
        scale = float(r.abs().max()) + 1.0
        assert float((a - r).abs().max()) <= 1e-4 * scale, name
    dl = torch.full((n,), 1.0 / n, device="cuda")
    dx, de = ce.lm_head_ce_bwd(x, e, tgt, ref[0], ref[1], dl, 0.1)
    rx, re = ce.lm_head_ce_bwd_reference(x, e, tgt, ref[0], ref[1], dl, 0.1)
    assert dx.shape == x.shape and de.shape == e.shape
    assert dx.dtype == dtype and de.dtype == dtype
    if dtype == torch.float32:
        _close_fp32(dx, rx)
        _close_fp32(de, re)
    else:
        _close_grad(dx, rx, "dx")
        _close_grad(de, re, "dE")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiny_gpt_h64_trains_through_the_kernels(gen, dtype):
    """The tests' own h64 GPT (2 layers, 2 heads: head dim 32) on the card:
    loss and gradients through the kernels against the plain versions."""
    from apex_tpu_torch.models.gpt import GPT, GPTConfig
    cfg = GPTConfig(vocab_size=256, max_seq_len=64, hidden_size=64,
                    num_layers=2, num_heads=2, dtype=dtype)
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0))
    ids = torch.randint(0, 256, (2, 64), generator=gen, device="cuda")
    labels = torch.roll(ids, -1, 1)
    params = [p for _, p in model.named_parameters()]
    n0 = ce.lm_head_ce_bwd.launches
    loss = model.loss(ids, labels)
    grads = torch.autograd.grad(loss, params)
    assert ce.lm_head_ce_bwd.launches == n0 + 1
    ref_loss = model.loss(ids, labels, reference=True)
    refs = torch.autograd.grad(ref_loss, params)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    assert abs(float(loss) - float(ref_loss)) <= tol * float(ref_loss)
    for g, r in zip(grads, refs):
        rel = float((g.float() - r.float()).norm()
                    / r.float().norm().clamp_min(1e-30))
        assert rel <= (1e-4 if dtype == torch.float32 else 3e-2), rel


@pytest.mark.parametrize("m", [8, 512])
@pytest.mark.parametrize("K,N", [(1000, 1000), (40, 24), (1024, 1000)])
def test_fp8_matmul_pads_k_and_n(gen, m, K, N):
    x = _rand(gen, m, K)
    w = _rand(gen, K, N, dtype=torch.float32) * K ** -0.5
    q, scale = mm.quantize_weight(w)
    before = mm.fp8_dequant_matmul.launches
    y = mm.fp8_dequant_matmul(x, q, scale)
    assert mm.fp8_dequant_matmul.launches == before + 1
    assert y.shape == (m, N)
    _close(y, mm.fp8_dequant_matmul_reference(x, q, scale), 1e-3)


@pytest.mark.parametrize("op", ["mul", "max", "where", "iota_cmp_where",
                                "exp", "exp2"])
def test_vpu_probe_matches_plain(gen, op):
    from apex_tpu_torch.scripts import vpu_probe as vp
    x = _rand(gen, 3, vp.BQ, vp.BK, dtype=torch.float32)
    before = vp.vpu_probe_kernel.launches
    got = vp.vpu_probe_kernel(x, op)
    assert vp.vpu_probe_kernel.launches == before + 1
    ref = vp.vpu_probe_reference(x, op)
    ulps = int((got.view(torch.int32).long()
                - ref.view(torch.int32).long()).abs().max())
    assert ulps <= (2 if op in ("exp", "exp2") else 0), ulps


@pytest.mark.parametrize("n", [1, 5])
def test_bottleneck_matches_plain_and_cudnn(gen, n):
    from apex_tpu_torch.scripts import bottleneck_proto as bp
    p = bp.make_params(device="cuda")
    x = bp.make_input(n, device="cuda")
    before = bp.fused_block.launches
    y = bp.fused_block(x, p)
    assert bp.fused_block.launches == before + 1
    ref = bp.plain_block(x, p)
    # two bf16 ulps plus 2^-5: h1 and h2 round to bf16 on both sides
    diff = (y.float() - ref.float()).abs()
    assert bool((diff <= ref.float().abs() * 2.0 ** -6 + 2.0 ** -5).all())
    lib = bp.cudnn_block(x, p)
    assert float((y.float() - lib.float()).abs().max()) < 0.15
    with pytest.raises(ValueError, match="NHWC"):
        bp.fused_block(x[:, :28].contiguous(), p)


@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float16)])
@pytest.mark.parametrize("split", [False, True])
def test_flash_mixed_dtypes_match_plain(gen, dtypes, split):
    """q, k, v of mixed dtypes (dout in q's): the kernels run the promoted
    fp32 operands and round p and ds where the JAX kernels cast; the plain
    versions keep fp32, so the bf16 limits hold."""
    b, h, sq, sk, d = 2, 3, 97, 130, 64
    q = _rand(gen, b, h, sq, d, dtype=dtypes[0])
    k = _rand(gen, b, h, sk, d, dtype=dtypes[1])
    v = _rand(gen, b, h, sk, d, dtype=dtypes[2])
    do = _rand(gen, b, h, sq, d, dtype=dtypes[0])
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
    assert out.dtype == dtypes[0]
    _close(out, ref, 4e-3)
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, True,
                               d ** -0.5, split=split)
    refs = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                            causal=True)
    for name, g, r, dt in zip(("dq", "dk", "dv"), grads, refs, dtypes):
        assert g.dtype == dt and g.shape == r.shape
        _close_grad(g, r, name)


@pytest.mark.parametrize("d,q_dtype,pool", [
    (80, torch.bfloat16, "same"), (80, torch.bfloat16, "e4m3"),
    (96, torch.bfloat16, "same"), (96, torch.float16, "e4m3"),
    (256, torch.bfloat16, "same"), (256, torch.bfloat16, "e4m3"),
    (100, torch.bfloat16, "same"), (100, torch.float32, "e4m3"),
    (512, torch.bfloat16, "same"), (512, torch.bfloat16, "e4m3"),
    (64, torch.float32, torch.bfloat16), (64, torch.bfloat16, torch.float32),
    (80, torch.float16, torch.bfloat16),
])
def test_paged_decode_any_head_dim_and_pool_dtype_matches_plain(
        gen, d, q_dtype, pool):
    """Any head dim (d % 8 != 0 takes the masked loads, d 512 two pieces a
    lane) over the pool read in place, and queries over a pool of another
    dtype; group 12 runs in chunks."""
    b, kv, g, page, npg = 3, 2, 12, 16, 9
    q = _rand(gen, b, kv, g, d, dtype=q_dtype)
    pool_dtype = q_dtype if pool in ("same", "e4m3") else pool
    kp = _rand(gen, kv, npg, page, d, dtype=pool_dtype)
    vp = _rand(gen, kv, npg, page, d, dtype=pool_dtype)
    bt = torch.tensor([[1, 2, 3, 0], [4, 0, 0, 0], [5, 6, 7, 8]],
                      dtype=torch.int32, device="cuda")
    sl = torch.tensor([40, 0, 64], dtype=torch.int32, device="cuda")
    ks = vs = None
    if pool == "e4m3":
        ks = torch.rand(kv, npg, generator=gen, device="cuda") + 0.5
        vs = torch.rand(kv, npg, generator=gen, device="cuda") + 0.5
        kp = (kp.float() * ks[:, :, None, None]).to(torch.float8_e4m3fn)
        vp = (vp.float() * vs[:, :, None, None]).to(torch.float8_e4m3fn)
    out = fa.paged_decode_attention(q, kp, vp, bt, sl, k_scales=ks,
                                    v_scales=vs)
    ref = fa.paged_attention_reference(q, kp, vp, bt, sl, k_scales=ks,
                                       v_scales=vs)
    assert out.dtype == q_dtype and out.shape == q.shape
    if q_dtype == torch.float32:
        _close_fp32(out, ref, 1e-5)
    else:
        _close(out, ref, 1e-3)
    assert float(out[1].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the wgmma/TMA LM-head CE (B8, B9): bf16 and fp16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M,N,K", [(128, 128, 64), (256, 384, 1024),
                                   (200, 136, 72), (8, 8, 8)])
def test_wgmma_core_layouts_match_matmul(gen, dtype, M, N, K):
    """The shared GEMM core alone, each operand K-major or MN-major (the
    transpose bits and the swizzled descriptors), ragged tiles included:
    fp32 sums of exact products within 1e-5 of the largest |C|."""
    A = _rand(gen, M, K, dtype=dtype)
    B = _rand(gen, K, N, dtype=dtype)
    ref = A.float() @ B.float()
    for a_mn in (False, True):
        for b_mn in (False, True):
            a = A.t().contiguous() if a_mn else A
            b = B if b_mn else B.t().contiguous()
            c = ce.wgmma_probe(a, b, a_mn, b_mn)
            assert float((c - ref).abs().max()) <= \
                1e-5 * float(ref.abs().max()), (a_mn, b_mn)


def _ce_inputs(gen, n, V, h, dtype, seed):
    x = _rand(gen, n, h, dtype=dtype)
    e = _rand(gen, V, h, dtype=dtype).mul(0.05)
    # ids in [-1, V]: out-of-range targets at both ends match no row
    tgt = torch.from_numpy(np.random.RandomState(seed).randint(
        -1, V + 1, n).astype(np.int32)).cuda()
    return x, e, tgt


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n,V,h,ls", [
    (8192, 32768, 1024, 0.0), (8192, 50257, 64, 0.1),
    (8192, 1000, 1600, 0.0), (1000, 32768, 100, 0.1),
    (1000, 50257, 1024, 0.0), (1000, 1000, 64, 0.1),
    (1000, 32768, 1600, 0.1), (8192, 1000, 100, 0.1),
])
def test_lm_head_ce_sm90_matches_plain(gen, dtype, n, V, h, ls):
    """The wgmma kernels (one launch count a call) against the plain
    versions at the CE limits of PERF.md §2, V a multiple of 128 or not."""
    x, e, tgt = _ce_inputs(gen, n, V, h, dtype, n + V + h)
    f0, b0 = ce.lm_head_ce_fwd.launches, ce.lm_head_ce_bwd.launches
    got = ce.lm_head_ce_fwd(x, e, tgt, ls > 0)
    ref = ce.lm_head_ce_fwd_reference(x, e, tgt, ls > 0)
    assert ce.lm_head_ce_fwd.launches == f0 + 1
    for name, a, r in zip(("m", "l", "pred", "ssum"), got, ref):
        if r is None:
            assert a is None
            continue
        assert float((a - r).abs().max()) <= 1e-4 * (
            float(r.abs().max()) + 1.0), name
    dl = torch.rand(n, generator=gen, device="cuda") / n
    dx, de = ce.lm_head_ce_bwd(x, e, tgt, ref[0], ref[1], dl, ls)
    assert ce.lm_head_ce_bwd.launches == b0 + 1
    rx, re = ce.lm_head_ce_bwd_reference(x, e, tgt, ref[0], ref[1], dl, ls)
    assert dx.dtype == dtype and de.dtype == dtype
    _close_grad(dx, rx, "dx")
    _close_grad(de, re, "dE")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_lm_head_ce_bwd_many_chunks_and_bitwise_rerun(gen, dtype,
                                                      monkeypatch):
    """The workspace cap lowered so that 1000 tokens run in 4 chunks
    (first, two middle, last fp32 dE passes): against the plain version and
    against the uncapped run; two runs give the same bits (no atomics)."""
    n, V, h = 1000, 5000, 200
    x, e, tgt = _ce_inputs(gen, n, V, h, dtype, 7)
    m, l, _, _ = ce.lm_head_ce_fwd_reference(x, e, tgt)
    dl = torch.rand(n, generator=gen, device="cuda") / n
    one = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl, 0.1)
    monkeypatch.setattr(ce, "G_WORKSPACE_BYTES", 256 * 5008 * 2)
    assert -(-n // ce.bwd_chunk_tokens(n, V)) == 4
    dx, de = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl, 0.1)
    dx2, de2 = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl, 0.1)
    assert torch.equal(dx, dx2) and torch.equal(de, de2)
    assert torch.equal(dx, one[0])          # dx is per chunk either way
    rx, re = ce.lm_head_ce_bwd_reference(x, e, tgt, m, l, dl, 0.1)
    _close_grad(dx, rx, "dx")
    _close_grad(de, re, "dE")
    _close_grad(de, one[1], "dE one chunk")


@pytest.mark.parametrize("h", [64, 100, 1024, 1536, 2048])
@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_lm_head_ce_f32_route_matches_plain_and_reruns_bitwise(gen, h, ls):
    """The fp32 route (csrc/lm_head_ce.cu on the FFMA core) at ragged n and
    V: the statistics within 1e-4 of the largest, dx and dE within 1e-4 of
    the largest and in norm, both the same bits on a rerun; one launch a
    call on the fp32 counters."""
    n, V = 300, 3001
    x = _rand(gen, n, h, dtype=torch.float32)
    e = _rand(gen, V, h, dtype=torch.float32).mul(0.05)
    tgt = torch.from_numpy(np.random.RandomState(h).randint(
        -1, V, n).astype(np.int32)).cuda()
    n0 = (ce.lm_head_ce_fwd.f32_launches, ce.lm_head_ce_bwd.f32_launches)
    got = ce.lm_head_ce_fwd(x, e, tgt, ls > 0)
    ref = ce.lm_head_ce_fwd_reference(x, e, tgt, ls > 0)
    for name, a, r in zip(("m", "l", "pred", "ssum"), got, ref):
        if r is None:
            assert a is None
            continue
        assert float((a - r).abs().max()) <= 1e-4 * (
            float(r.abs().max()) + 1.0), name
    dl = torch.rand(n, generator=gen, device="cuda") / n
    dx, de = ce.lm_head_ce_bwd(x, e, tgt, ref[0], ref[1], dl, ls)
    dx2, de2 = ce.lm_head_ce_bwd(x, e, tgt, ref[0], ref[1], dl, ls)
    torch.cuda.synchronize()
    assert (ce.lm_head_ce_fwd.f32_launches - n0[0],
            ce.lm_head_ce_bwd.f32_launches - n0[1]) == (1, 2)
    assert torch.equal(dx, dx2) and torch.equal(de, de2)
    rx, re = ce.lm_head_ce_bwd_reference(x, e, tgt, ref[0], ref[1], dl, ls)
    _close_fp32(dx, rx)
    _close_fp32(de, re)


def test_lm_head_ce_f32_bwd_many_chunks(gen, monkeypatch):
    """The fp32 workspace cap lowered so that 1000 tokens run in 4 chunks
    (dE stored by the first, added in place by the others, in order):
    dx bitwise the one-chunk run's, dE within the fp32 limits of it and of
    the plain version, the same bits on a rerun."""
    n, V, h = 1000, 5003, 200
    x = _rand(gen, n, h, dtype=torch.float32)
    e = _rand(gen, V, h, dtype=torch.float32).mul(0.05)
    tgt = torch.from_numpy(np.random.RandomState(5).randint(
        0, V, n).astype(np.int32)).cuda()
    m, l, _, _ = ce.lm_head_ce_fwd_reference(x, e, tgt)
    dl = torch.rand(n, generator=gen, device="cuda") / n
    one = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl, 0.1)
    monkeypatch.setattr(ce, "F32_WORKSPACE_BYTES", 2 * 256 * 5004 * 4)
    assert -(-n // ce.f32_chunk_tokens(n, V)) == 4
    dx, de = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl, 0.1)
    dx2, de2 = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl, 0.1)
    assert torch.equal(dx, dx2) and torch.equal(de, de2)
    assert torch.equal(dx, one[0])
    rx, re = ce.lm_head_ce_bwd_reference(x, e, tgt, m, l, dl, 0.1)
    _close_fp32(dx, rx)
    _close_fp32(de, re)
    _close_fp32(de, one[1])


def test_lm_head_ce_bwd_gpt_shape_bitwise_rerun(gen):
    """At the GPT step's n 8192, V 32768, h 1024 (two chunks): two runs give
    the same dx and dE bits."""
    x, e, tgt = _ce_inputs(gen, 8192, 32768, 1024, torch.bfloat16, 8)
    m, l, _, _ = ce.lm_head_ce_fwd_reference(x, e, tgt)
    dl = torch.full((8192,), 1.0 / 8192, device="cuda")
    a = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl)
    b = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# the decode kernels' cuts (B12's K splits, B5's pieces): a row is bitwise
# the same whatever rows come with it, and on a rerun
# ---------------------------------------------------------------------------

def _paged_case(gen, b, kv, g, d, page, m, seq_lens, fp8_pool=False, bt=None,
                num_pages=None):
    num_pages = num_pages or 1 + b * m
    q = _rand(gen, b, kv, g, d)
    ks = vs = None
    if fp8_pool:
        x = _rand(gen, 2, kv, num_pages, page, d, dtype=torch.float32)
        s = fp8.compute_scale(x.abs().amax(dim=(3, 4)), fp8.E4M3_MAX, 2.0)
        pools = fp8.quantize(x, s[..., None, None], fp8.E4M3)
        kp, vp = pools[0], pools[1]
        ks, vs = s[0].contiguous(), s[1].contiguous()
    else:
        kp = _rand(gen, kv, num_pages, page, d)
        vp = _rand(gen, kv, num_pages, page, d)
    if bt is None:
        rng = np.random.RandomState(sum(seq_lens) + b)
        bt = rng.permutation(np.arange(1, num_pages))[:b * m].reshape(b, m)
        bt = torch.from_numpy(bt.astype(np.int32)).cuda()
    sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, sl, dict(k_scales=ks, v_scales=vs)


@pytest.mark.parametrize("fp8_pool", [False, True])
def test_paged_decode_row_is_bitwise_independent_of_other_rows(gen,
                                                               fp8_pool):
    """Row 5's output is bitwise the same when every other row changes
    (other seq_lens, other pages, other queries) and alone in a batch of
    one, and every output is bitwise the same on a rerun."""
    b, kv, g, d, page, m = 8, 16, 1, 64, 128, 8
    q, kp, vp, bt, sl, sc = _paged_case(
        gen, b, kv, g, d, page, m, [0, 1, 127, 128, 129, 300, 640, 1024],
        fp8_pool)
    out = fa.paged_decode_attention(q, kp, vp, bt, sl, **sc)
    assert torch.equal(out, fa.paged_decode_attention(q, kp, vp, bt, sl,
                                                      **sc))
    _close(out, fa.paged_attention_reference(q, kp, vp, bt, sl, **sc), 1e-3)
    q2 = _rand(gen, b, kv, g, d)
    q2[5] = q[5]
    bt2 = torch.roll(bt, 1, dims=0).contiguous()
    bt2[5] = bt[5]
    sl2 = torch.tensor([700, 0, 5, 1000, 2, 300, 0, 64], dtype=torch.int32,
                       device="cuda")
    out2 = fa.paged_decode_attention(q2, kp, vp, bt2, sl2, **sc)
    assert torch.equal(out2[5], out[5])
    one = fa.paged_decode_attention(q[5:6].contiguous(), kp, vp,
                                    bt[5:6].contiguous(), sl[5:6], **sc)
    assert torch.equal(one[0], out[5])


@pytest.mark.parametrize("page", [8, 16, 128])
@pytest.mark.parametrize("fp8_pool", [False, True])
def test_paged_decode_serve_shapes_match_plain(gen, page, fp8_pool):
    """The spec engine's shapes: a draft call (one active row of 300 keys in
    the fixed batch of 8) and a verify call (five rows of one sequence at
    300-304 keys over one block table), each row of the verify call bitwise
    the row of a plain decode call at the same position."""
    b, kv, g, d = 8, 16, 1, 64
    m = -(-1024 // page)
    row = torch.arange(1, m + 1, dtype=torch.int32, device="cuda")
    bt = torch.zeros(b, m, dtype=torch.int32, device="cuda")
    bt[:5] = row
    q, kp, vp, bt, _, sc = _paged_case(gen, b, kv, g, d, page, m, [0] * b,
                                       fp8_pool, bt=bt, num_pages=1 + m)
    for lens in ([300, 0, 0, 0, 0, 0, 0, 0],
                 [300, 301, 302, 303, 304, 0, 0, 0]):
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out = fa.paged_decode_attention(q, kp, vp, bt, sl, **sc)
        ref = fa.paged_attention_reference(q, kp, vp, bt, sl, **sc)
        _close(out, ref, 1e-3)
        for i, n in enumerate(lens):
            if n == 0:
                assert float(out[i].abs().max()) == 0.0
    # verify row i against the plain-decode call that carries the same
    # sequence at the same position among other sequences
    for i in range(5):
        sl1 = torch.tensor([17, 0, 300 + i, 1000, 0, 0, 129, 1],
                           dtype=torch.int32, device="cuda")
        q1, bt1 = q.clone(), bt.clone()
        q1[2] = q[i]
        bt1[2] = row
        bt1[[0, 3, 6, 7]] = torch.roll(row, 1)
        plain = fa.paged_decode_attention(q1, kp, vp, bt1, sl1, **sc)
        assert torch.equal(plain[2], out[i])


def test_paged_decode_general_path_rows_are_bitwise_independent(gen):
    """The general path (d 100, a pool of another dtype, group 12 in
    chunks): rows bitwise independent of the others and on a rerun."""
    b, kv, g, d, page, m = 3, 2, 12, 100, 16, 9
    q, kp, vp, bt, sl, _ = _paged_case(gen, b, kv, g, d, page, m,
                                       [40, 0, 140])
    kp, vp = kp.float(), vp.float()
    out = fa.paged_decode_attention(q, kp, vp, bt, sl)
    _close(out, fa.paged_attention_reference(q, kp, vp, bt, sl), 1e-3)
    assert torch.equal(out, fa.paged_decode_attention(q, kp, vp, bt, sl))
    one = fa.paged_decode_attention(q[2:3].contiguous(), kp, vp,
                                    bt[2:3].contiguous(), sl[2:3])
    assert torch.equal(one[0], out[2])


@pytest.mark.parametrize("K,N", [(1024, 3072), (1024, 1024), (1024, 4096),
                                 (4096, 1024)])
def test_fp8_matmul_decode_rows_bitwise_independent_and_rerun(gen, K, N):
    """A decode-regime row is bitwise the same when the other rows of x
    change, and alone (m 1 against m 8); the whole product is bitwise the
    same on a rerun (no atomics)."""
    x = _rand(gen, 8, K)
    q, scale = mm.quantize_weight(_rand(gen, K, N, dtype=torch.float32)
                                  * K ** -0.5)
    y = mm.fp8_dequant_matmul(x, q, scale)
    assert torch.equal(y, mm.fp8_dequant_matmul(x, q, scale))
    x2 = _rand(gen, 8, K)
    x2[6] = x[6]
    assert torch.equal(mm.fp8_dequant_matmul(x2, q, scale)[6], y[6])
    for r in (0, 6, 7):
        y1 = mm.fp8_dequant_matmul(x[r:r + 1].contiguous(), q, scale)
        assert torch.equal(y1[0], y[r])
    y3 = mm.fp8_dequant_matmul(x[2:5].contiguous(), q, scale)
    assert torch.equal(y3, y[2:5])
