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

The fp32 backward's FFMA route (``csrc/flash_bwd_f32.cuh``: the single
pass and the split's dk/dv at kernel head dims 64 and 128) is held within
1e-4 of the plain backward (fp32 on both sides, sums in another order,
``__expf``) over ragged s, sq != sk, rows with no key, padded head dims,
segment padding (its dq exactly zero) and non-causal masks; dq, dk and dv
bitwise on a rerun and for one batch alone; and an fp32 GPT's autograd
runs every flash forward and backward on the FFMA routes (the split's dq
included), its loss within 1e-5 and its gradients 1e-4 of the plain path.

The fp32 forward's FFMA route (``csrc/flash_fwd_f32.cuh``, kernel head
dims 64 and 128) is held within 1e-5 of the plain version (lse 1e-5
relative) and the split's dq on the FFMA route (``flash_dq_f32_kernel``,
reading the dk/dv call's transposed scratch, or alone its own) within
1e-4, over the same shapes; both bitwise on a rerun and for one batch
alone, padding rows exactly zero.

The wgmma/TMA forward and single pass (``csrc/flash_fwd_sm90.cu``,
``flash_bwd_fused_sm90``) are held at the same tolerances, over ragged s,
sq != sk, segment padding, d 64/128 and padded, bf16 and fp16; the forward
and the single pass's dk, dv bitwise on a rerun, its dq not (bulk
reductions into an fp32 accumulator in a varying order).

Attention dropout on the wgmma route (the forward's, the single pass's and
the split's dropout variants) is held at the same limits against the plain
versions with the same seed, whose forward rounds the dropped p to v's
dtype before the PV product as the kernel does (scaled by 1 / (1 - rate),
the largest p of a row is no longer exactly 1 in bf16); bitwise on a
rerun; and each kernel's mask is the plain mask bit for bit (the forward:
v the identity; the split's dk/dv: do the identity; its dq: k the
identity and a zero output).

The additive bias on the wgmma route (the forward's, the single pass's and
the split's bias variants) is held at the same limits against the plain
versions with the same bias, over bf16 and fp16, head dims 64 and 128, the
four broadcast shapes, sq != sk, odd sk, segment padding, -inf entries and
a row that is -inf everywhere (out 0, lse -1e30, dq 0); bitwise on a rerun;
its positions bitwise through one-hot rows (out is v permuted, dv is do
permuted; through the split with v = e_0 and a zero output, dq, dk and dv
are exact products and so bitwise); the refused routes raise before any
launch, naming the route. The bias with dropout (the variants with both
of the forward, the single pass and the split) is held the same way
against the plain versions with the same bias and seed, its keep pattern
bitwise through the identity operands above under a bias finite
everywhere and its positions through one-hot rows at rate 0.5 (the kept
elements doubled, exactly). Attention dropout on the fp32 FFMA route (the
forward's and the single pass's dropout variants) is held at the fp32
limits against the plain versions with the same seed, bitwise on a rerun,
its keep pattern the plain mask bit for bit (the forward: v the identity;
the single pass: do the identity). The FFMA split's dropout variants
(dk/dv and dq) and the FFMA route's bias variants (the forward, the single
pass, the split's dk/dv and dq) are held the same way: against the plain
versions with the same seed or bias, the keep pattern bitwise through
the identity operands, each broadcast shape of the bias with a row -inf
everywhere (a dead row, dq exactly 0) and a row -inf but for key 0, which
the mask keeps (its output v[0] bit for bit), bitwise on a rerun. The FFMA
route's variants with both the bias and dropout (the forward, the single
pass, the split's dk/dv and dq) are held the same way against the plain
versions with the same bias and seed, the one-key row's output v[0] / (1 -
rate) or 0 by its keep bit, the keep pattern bitwise under a finite bias;
frag.cuh refuses the pair before any launch. The wgmma bias variants, with
and without dropout, on rows whose bias is at the -1e30 fill or just above
it on every kept key: live rows (the kept mean, lse the fill, p = 1 on
each kept key in the backward) against the plain forward and backward end
to end.

The fp8 dequant-matmul's prefill regime (m > 8, wgmma/TMA with the
weight converted in registers, ``_prefill_plan``) is held like its decode
regime at the serve linears and padded K, N, bitwise on a rerun, each row
bitwise the same whatever rows come with it, one device launch a call. The
LayerNorm backward (``csrc/layer_norm_bwd.cu``: a warp a row to h 1024, a
block a row past it) is held at every shape and dtype the kernel takes,
bitwise on a rerun, one device launch a call (no second pass).

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
composition, bitwise on a rerun and for one image alone.
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
    # an additive bias runs on the wgmma route (B1's bias variant): a zero
    # bias gives the kernel's result without one, bit for bit
    n0 = fa.flash_attention.bias_launches
    got = fa.flash_attention(q, q, q, bias=torch.zeros(1, 2, 16, 16,
                                                       device="cuda"))
    assert fa.flash_attention.bias_launches == n0 + 1
    assert torch.equal(got, fa.flash_attention(q, q, q))
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


# attention dropout on the wgmma route: the forward and the single pass
# regenerate the plain version's mask (dropout_keep_reference) bit for bit
_DROPOUT_CASES = [
    (2, 3, 77, 77, 64, True, False, _BF, 0.1, 1234),
    (1, 2, 300, 129, 128, True, False, _F16, 0.1, -7),
    (2, 2, 257, 257, 80, False, True, _BF, 0.3, 2 ** 31 - 1),
    (1, 2, 17, 200, 128, True, True, _BF, 0.5, 0),
    (2, 4, 512, 512, 64, True, True, _F16, 0.9, 99),
]


@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg,dtype,rate,seed",
                         _DROPOUT_CASES)
def test_flash_dropout_wgmma_route_matches_plain(gen, b, h, sq, sk, d,
                                                 causal, seg, dtype, rate,
                                                 seed):
    """The forward's and the single pass's dropout variants against the
    plain versions with the same seed, at the no-dropout cases' limits
    (the plain forward rounds the dropped p to v's dtype as the kernel
    does); both bitwise on a rerun, another seed another output; one
    launch of each on the dropout counters."""
    q, k, v, do, sid_q, sid_kv = _wgmma_inputs(gen, b, h, sq, sk, d, seg,
                                               dtype)
    f, g = fa.flash_attention, fa.flash_attention_bwd
    n0 = (f.dropout_launches, g.dropout_launches)
    drop = dict(dropout_rate=rate, dropout_seed=seed)
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal,
                                      **drop)
    again = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal, **drop)
    other = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal,
                                   dropout_rate=rate, dropout_seed=seed ^ 1)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, sid_q, sid_kv,
                                   causal, **drop)
    grads2 = fa.flash_attention_bwd(q, k, v, out, lse, do, sid_q, sid_kv,
                                    causal, **drop)
    torch.cuda.synchronize()
    assert (f.dropout_launches, g.dropout_launches) == (n0[0] + 3,
                                                        n0[1] + 2)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert not torch.equal(out, other[0])
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, grads2))
    ref, ref_lse = fa.flash_attention_reference(
        q, k, v, causal=causal, segment_ids_q=sid_q, segment_ids_kv=sid_kv,
        **drop)
    _close(out, ref, 4e-3)
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    ref_grads = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=causal, segment_ids_q=sid_q,
        segment_ids_kv=sid_kv, **drop)
    for name, got, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        assert got.dtype == dtype
        _close_grad(got, r, name)


@pytest.mark.parametrize("dtype,d", [(_BF, 64), (_F16, 128)])
@pytest.mark.parametrize("seed", [5, -3])
def test_flash_dropout_mask_is_the_plain_mask(gen, dtype, d, seed):
    """q = k = 0 and v = I over sk = d keys, non-causal, rate 0.5: out[q, k]
    is 2 / sk where the key is kept and exactly 0 where it is dropped, so
    the zero pattern is the kernel's mask, bitwise the plain one."""
    b, h, sq = 2, 3, 333
    q = torch.zeros(b, h, sq, d, device="cuda", dtype=dtype)
    k = torch.zeros(b, h, d, d, device="cuda", dtype=dtype)
    v = torch.eye(d, device="cuda", dtype=dtype).expand(b, h, d, d)
    out, _ = fa.flash_attention_fwd(q, k, v.contiguous(), None, None, False,
                                    1.0, 0.5, seed)
    keep = fa.dropout_keep_reference(seed, b, h, sq, d, 0.5, device="cuda")
    assert torch.equal(out != 0, keep)
    assert torch.equal(out[keep].float(),
                       torch.full_like(out[keep].float(), 2.0 / d))


# the split's dropout variants: bf16 and fp16, d 64 and 128 (and a padded
# d), causal, non-causal and ragged with segment ids, sq != sk both ways;
# the last case is one the gate itself sends to the split (split None)
_SPLIT_DROPOUT_CASES = [
    (2, 3, 300, 300, 64, True, False, _BF, 0.1, 1234, True),
    (1, 2, 257, 129, 128, False, False, _F16, 0.3, -7, True),
    (2, 2, 333, 333, 64, True, True, _F16, 0.5, 2 ** 31 - 1, True),
    (1, 2, 129, 300, 128, True, True, _BF, 0.1, 0, True),
    (2, 2, 200, 77, 64, False, True, _BF, 0.9, 99, True),
    (1, 2, 777, 777, 80, True, True, _F16, 0.2, -2 ** 31, True),
    (2, 8, 1024, 1024, 128, True, False, _BF, 0.1, 5, None),
]


@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg,dtype,rate,seed,split",
                         _SPLIT_DROPOUT_CASES)
def test_flash_split_dropout_wgmma_route_matches_plain(
        gen, b, h, sq, sk, d, causal, seg, dtype, rate, seed, split):
    """The split's dropout variants (dq with the delta fold, then dk/dv)
    against the plain backward with the same seed, and each kernel against
    its own plain version, at the bf16 backward limits; bitwise on a
    rerun, another seed another result; one launch on each dropout
    counter a call, none on the single pass."""
    q, k, v, do, sid_q, sid_kv = _wgmma_inputs(gen, b, h, sq, sk, d, seg,
                                               dtype)
    if split is None:
        assert fa.uses_split_backward(sq, sk, d, 2, 2, causal, dropout=True)
        assert not fa.uses_split_backward(sq, sk, d, 2, 2, causal)
    g = fa.flash_attention_bwd
    drop = dict(dropout_rate=rate, dropout_seed=seed)
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal,
                                      **drop)

    def counts():
        return (g.launches, g.dropout_dkdv_launches, g.dropout_dq_launches,
                g.wgmma_dkdv_launches, g.wgmma_dq_launches)

    def bwd(o, l_, **kw):
        return fa._flash_bwd_cuda(q, k, v, o, l_, do, sid_q, sid_kv, causal,
                                  d ** -0.5, split=split, **kw)

    n0 = counts()
    grads = bwd(out, lse, **drop)
    torch.cuda.synchronize()
    assert tuple(a - b_ for a, b_ in zip(counts(), n0)) == (0, 1, 1, 1, 1)
    assert all(torch.equal(x, y) for x, y in zip(grads, bwd(out, lse,
                                                          **drop)))
    other_out, other_lse = fa.flash_attention_fwd(
        q, k, v, sid_q, sid_kv, causal, dropout_rate=rate,
        dropout_seed=seed ^ 1)
    other = bwd(other_out, other_lse, dropout_rate=rate,
                dropout_seed=seed ^ 1)
    assert not torch.equal(grads[2], other[2])
    ref = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=causal, segment_ids_q=sid_q,
        segment_ids_kv=sid_kv, **drop)
    for name, got, r in zip(("dq", "dk", "dv"), grads, ref):
        assert got.dtype == dtype
        _close_grad(got, r, name)
    if seg:
        pad = (sid_q < 0)[:, None, :].expand(b, h, sq)
        assert not bool(grads[0][pad].any())
    kd = fa.kernel_head_dim(d)
    if kd == d:       # each kernel alone, against its plain version
        delta = torch.empty(b, h, sq, dtype=torch.float32, device="cuda")
        args = (q, k, v, do, lse, delta, sid_q, sid_kv, causal, d ** -0.5,
                fa._mixed_rounds(q, k, do))
        dargs = fa._dropout_args(rate, seed)
        dq = fa._flash_dq_cuda(*args, out=out, dropout=dargs)
        dk, dv = fa._flash_dkdv_cuda(*args, dropout=dargs)
        kw = dict(causal=causal, segment_ids_q=sid_q, segment_ids_kv=sid_kv,
                  **drop)
        rdq, rdelta = fa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw)
        rdk, rdv = fa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do,
                                               **kw)
        torch.cuda.synchronize()
        assert float((delta - rdelta).abs().max()) <= \
            1e-5 * float(rdelta.abs().max())
        for name, got, r in (("dq", dq, rdq), ("dk", dk, rdk),
                             ("dv", dv, rdv)):
            _close_grad(got, r, name)
        assert all(torch.equal(x, y) for x, y in zip((dq, dk, dv), grads))


@pytest.mark.parametrize("dtype,d", [(_BF, 64), (_F16, 128)])
@pytest.mark.parametrize("seed", [5, -3])
def test_flash_split_dropout_masks_are_the_plain_mask(gen, dtype, d, seed):
    """Rate 0.5, no attention mask (p > 0 everywhere): dk/dv with q = 0
    (p = 1 / sk, no fp16 underflow) and do = I over sq = d rows gives dv =
    the dropped p transposed; dq with k = I
    over sk = d keys and out = 0 (so the folded delta is 0) is zero
    exactly where a key is dropped. Both zero patterns are the plain mask
    bit for bit."""
    b, h, s = 2, 3, 333
    eye = torch.eye(d, device="cuda", dtype=dtype).expand(b, h, d, d)
    eye = eye.contiguous()
    half = fa._dropout_args(0.5, seed)
    rounds = fa._mixed_rounds(eye, eye, eye)
    k, v = (_rand(gen, b, h, s, d, dtype=dtype) for _ in range(2))
    q = torch.zeros(b, h, d, d, device="cuda", dtype=dtype)
    _, lse = fa.flash_attention_fwd(q, k, v, None, None, False, 1.0)
    zero = torch.zeros(b, h, d, dtype=torch.float32, device="cuda")
    _, dv = fa._flash_dkdv_cuda(q, k, v, eye, lse, zero, None, None, False,
                                1.0, rounds, dropout=half)
    keep = fa.dropout_keep_reference(seed, b, h, d, s, 0.5, device="cuda")
    assert torch.equal(dv != 0, keep.transpose(-1, -2))
    q, v, do = (_rand(gen, b, h, n, d, dtype=dtype) for n in (s, d, s))
    _, lse = fa.flash_attention_fwd(q, eye, v, None, None, False, 1.0)
    delta = torch.empty(b, h, s, dtype=torch.float32, device="cuda")
    dq = fa._flash_dq_cuda(q, eye, v, do, lse, delta, None, None, False,
                           1.0, rounds, out=torch.zeros_like(q),
                           dropout=half)
    keep = fa.dropout_keep_reference(seed, b, h, s, d, 0.5, device="cuda")
    assert float(delta.abs().max()) == 0.0
    assert torch.equal(dq != 0, keep)


def test_flash_dropout_refuses_the_unported_routes_on_the_card(gen):
    """Dropout on a route without it raises before any launch, naming the
    route: frag.cuh. The fp32 FFMA route takes it in the single pass and,
    at s4096, in its split (the split's dropout variants); the split at
    s4096 takes it on the wgmma route, and the single pass takes a bias
    with dropout (its variant with both)."""
    q = _rand(gen, 1, 2, 64, 64)
    f32 = q.float().requires_grad_()
    g = fa.flash_attention_bwd
    n0 = g.f32_dropout_launches
    fa.flash_attention(f32, f32, f32, dropout_rate=0.1,
                       dropout_seed=1).sum().backward()
    torch.cuda.synchronize()
    assert g.f32_dropout_launches == n0 + 1
    long32 = _rand(gen, 1, 1, 4096, 64, dtype=torch.float32)
    long32.requires_grad_()
    n0 = (g.f32_dropout_dkdv_launches, g.f32_dropout_dq_launches)
    fa.flash_attention(long32, long32, long32, causal=True, dropout_rate=0.1,
                       dropout_seed=1).sum().backward()
    torch.cuda.synchronize()
    assert (g.f32_dropout_dkdv_launches - n0[0],
            g.f32_dropout_dq_launches - n0[1]) == (1, 1)
    assert bool(torch.isfinite(long32.grad).all())
    q32 = _rand(gen, 1, 2, 64, 32)
    with pytest.raises(NotImplementedError, match="frag.cuh"):
        fa.flash_attention(q32, q32, q32, dropout_rate=0.1, dropout_seed=1)
    qs = _rand(gen, 1, 1, 4096, 64).requires_grad_()
    g = fa.flash_attention_bwd
    n0 = (g.dropout_dkdv_launches, g.dropout_dq_launches)
    fa.flash_attention(qs, qs, qs, causal=True, dropout_rate=0.1,
                       dropout_seed=1).float().sum().backward()
    torch.cuda.synchronize()
    assert (g.dropout_dkdv_launches, g.dropout_dq_launches) == (n0[0] + 1,
                                                                n0[1] + 1)
    assert bool(torch.isfinite(qs.grad).all())
    qg = q.detach().requires_grad_()
    n0 = g.bias_dropout_fused_launches
    fa.flash_attention(qg, qg, qg, bias=torch.zeros(1, 2, 64, 64,
                                                    device="cuda"),
                       dropout_rate=0.1,
                       dropout_seed=1).float().sum().backward()
    torch.cuda.synchronize()
    assert g.bias_dropout_fused_launches == n0 + 1
    assert bool(torch.isfinite(qg.grad).all())


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
# the fp32 forward (csrc/flash_fwd_f32.cuh, B1) and the split's dq
# (flash_dq_f32_kernel of csrc/flash_bwd_f32.cuh, B4) on the FFMA route
# ---------------------------------------------------------------------------

_F32_FWD_DQ_SHAPES = [
    (1, 1, 1, 5, 64, True, False),           # one query row
    (2, 3, 65, 65, 64, True, True),
    (1, 2, 127, 129, 64, True, False),       # about the query tiles
    (1, 2, 257, 255, 64, True, True),
    (1, 2, 129, 127, 128, True, True),
    (1, 2, 17, 300, 64, True, False),        # sq < sk: end-aligned causal
    (1, 2, 300, 90, 64, True, True),         # sq > sk: rows with no key
    (2, 2, 1000, 1003, 64, True, True),      # ragged, sq != sk
    (1, 2, 257, 257, 40, True, False),       # d 40 -> 64
    (1, 2, 300, 300, 80, False, True),       # d 80 -> 128, non-causal
    (2, 2, 200, 77, 64, False, True),
    (1, 1, 4097, 4100, 128, True, True),
]


@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg", _F32_FWD_DQ_SHAPES)
def test_flash_fwd_f32_route_matches_plain(gen, b, h, sq, sk, d, causal,
                                           seg):
    """fp32 operands at kernel head dims 64 and 128 take the FFMA forward:
    out within 1e-5 of the plain version, lse within 1e-5 relative (the
    -1e30 fill exactly on rows that see no key), padding rows exactly
    zero; the same bits on a rerun and for the last batch alone."""
    f32 = torch.float32
    q = _rand(gen, b, h, sq, d, dtype=f32)
    k, v = _rand(gen, b, h, sk, d, dtype=f32), _rand(gen, b, h, sk, d,
                                                     dtype=f32)
    sid_q = _f32_seg(b, sq, min(20, sq // 4)) if seg else None
    sid_kv = _f32_seg(b, sk, 0) if seg else None
    f = fa.flash_attention
    n0 = (f.launches, f.f32_launches)
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal)
    again = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal)
    last = fa.flash_attention_fwd(
        q[-1:], k[-1:], v[-1:], None if sid_q is None else sid_q[-1:],
        None if sid_kv is None else sid_kv[-1:], causal)
    torch.cuda.synchronize()
    assert (f.launches - n0[0], f.f32_launches - n0[1]) == (3, 3)
    ref, ref_lse = fa.flash_attention_reference(
        q, k, v, causal=causal, segment_ids_q=sid_q, segment_ids_kv=sid_kv)
    assert out.dtype == f32 and out.shape == ref.shape
    _close_fp32(out, ref, 1e-5)
    live = ref_lse > -1e29
    if bool(live.any()):
        rel = (lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)
        assert float(rel[live].max()) <= 1e-5
    assert torch.equal(lse[~live], ref_lse[~live])
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert torch.equal(out[-1:], last[0]) and torch.equal(lse[-1:], last[1])
    if seg:
        assert not bool(out[(sid_q < 0)[:, None, :].expand(b, h, sq)].any())


@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg", _F32_FWD_DQ_SHAPES)
def test_flash_dq_f32_route_matches_plain(gen, b, h, sq, sk, d, causal,
                                          seg):
    """The split's dq on the FFMA route: as the split calls it (on the
    scratch its dk/dv call transposed q and dO into) and alone (its own
    prologue), within 1e-4 of the plain dq kernel's version; the two the
    same bits, a rerun the same bits, the last batch alone the same bits,
    padding rows exactly zero."""
    f32 = torch.float32
    q, do = _rand(gen, b, h, sq, d, dtype=f32), _rand(gen, b, h, sq, d,
                                                      dtype=f32)
    k, v = _rand(gen, b, h, sk, d, dtype=f32), _rand(gen, b, h, sk, d,
                                                     dtype=f32)
    sid_q = _f32_seg(b, sq, min(20, sq // 4)) if seg else None
    sid_kv = _f32_seg(b, sk, 0) if seg else None
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal)
    kd = fa.kernel_head_dim(d)
    pad = [0, kd - d]
    qp, kp, vp, dop = (torch.nn.functional.pad(t, pad).contiguous()
                       for t in (q, k, v, do))
    delta = (do * out).sum(-1)
    args = (qp, kp, vp, dop, lse, delta, sid_q, sid_kv, causal, d ** -0.5,
            fa._mixed_rounds(q, k, do))
    f = fa.flash_attention_bwd
    n0 = (f.dq_launches, f.f32_dq_launches)
    ws = fa._f32_transposes(qp)
    fa._flash_dkdv_cuda(*args, ws=ws)
    got = fa._flash_dq_cuda(*args, ws=ws)
    alone = fa._flash_dq_cuda(*args)
    again = fa._flash_dq_cuda(*args)
    last = fa._flash_dq_cuda(*(t[-1:] if isinstance(t, torch.Tensor)
                               else t for t in args))
    torch.cuda.synchronize()
    assert (f.dq_launches - n0[0], f.f32_dq_launches - n0[1]) == (4, 4)
    assert torch.equal(got, alone) and torch.equal(got, again)
    assert torch.equal(got[-1:], last)
    ref, _ = fa.flash_bwd_dq_reference(q, k, v, out, lse, do, causal=causal,
                                       segment_ids_q=sid_q,
                                       segment_ids_kv=sid_kv)
    got = got[..., :d]
    assert got.dtype == f32 and got.shape == ref.shape
    _close_fp32(got, ref)
    if seg:
        assert not bool(got[(sid_q < 0)[:, None, :].expand(b, h, sq)].any())


@pytest.mark.parametrize("s", [1024, 4096])
def test_flash_f32_split_is_bitwise_on_a_rerun_and_alone(gen, s):
    """The fp32 split as autograd calls it (dk/dv, then dq on its
    scratch): dq, dk and dv the same bits on a rerun and for one batch
    alone, the forward's out and lse too."""
    f32 = torch.float32
    b, h, d = 2, 2, 64
    q, k, v, do = (_rand(gen, b, h, s, d, dtype=f32) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    one = fa.flash_attention_fwd(q[1:], k[1:], v[1:], causal=True)
    assert torch.equal(out[1:], one[0]) and torch.equal(lse[1:], one[1])
    args = (None, None, True, d ** -0.5)
    got = fa._flash_bwd_cuda(q, k, v, out, lse, do, *args, split=True)
    again = fa._flash_bwd_cuda(q, k, v, out, lse, do, *args, split=True)
    alone = fa._flash_bwd_cuda(q[1:], k[1:], v[1:], out[1:], lse[1:],
                               do[1:], *args, split=True)
    torch.cuda.synchronize()
    for g, a, o in zip(got, again, alone):
        assert torch.equal(g, a) and torch.equal(g[1:], o)


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


@pytest.mark.parametrize("n", [1, 3, 5, 7])
def test_bottleneck_matches_plain_and_cudnn(gen, n):
    """n 1, 3, 5, 7: ragged tile counts of the persistent grid (segments of
    1-4 bands, 56-112 blocks)."""
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


def test_bottleneck_bitwise_on_rerun_and_image_alone(gen):
    """Each output band is one block's fixed sequence of products: a second
    call gives the same bits, and each image of an n 5 batch (segments of 3
    bands) the same bits alone (segments of 1 band)."""
    from apex_tpu_torch.scripts import bottleneck_proto as bp
    p = bp.make_params(device="cuda")
    x = bp.make_input(5, device="cuda")
    y = bp.fused_block(x, p)
    assert torch.equal(y, bp.fused_block(x, p))
    for i in range(5):
        assert torch.equal(y[i:i + 1], bp.fused_block(x[i:i + 1].contiguous(),
                                                      p)), i


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


# ---------------------------------------------------------------------------
# the fp32 backward's FFMA route (csrc/flash_bwd_f32.cuh): B2 and B3
# ---------------------------------------------------------------------------

def _f32_seg(b, s, pad):
    sid = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    sid[:, s // 2:] = 1
    if pad:
        sid[:, s - pad:] = -1
    return sid


@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg", [
    (1, 1, 1, 5, 64, True, False),           # one query row
    (2, 3, 65, 65, 64, True, True),
    (1, 2, 127, 129, 64, True, False),       # about the 64-row tiles
    (1, 2, 129, 127, 128, True, True),
    (1, 2, 17, 300, 64, True, False),        # sq < sk: end-aligned causal
    (1, 2, 300, 90, 64, True, True),         # sq > sk: rows with no key
    (2, 2, 1000, 1003, 64, True, True),      # ragged, sq != sk
    (1, 2, 257, 257, 40, True, False),       # d 40 -> 64
    (1, 2, 300, 300, 80, False, True),       # d 80 -> 128, non-causal
    (2, 2, 200, 77, 64, False, True),
    (1, 1, 2049, 2049, 64, True, False),     # past the gate
    (1, 1, 4097, 4100, 128, True, True),
    (2048, 17, 8, 8, 64, True, False),       # b h past 65535 / 2
])
@pytest.mark.parametrize("split", [False, True])
def test_flash_bwd_f32_route_matches_plain(gen, b, h, sq, sk, d, causal,
                                           seg, split):
    """fp32 operands at kernel head dims 64 and 128 take the FFMA route
    (the single pass, or the split's dk/dv beside flash_bwd.cu's dq
    kernel): within 1e-4 of the plain backward; padding rows' dq exactly
    zero."""
    f32 = torch.float32
    q, do = _rand(gen, b, h, sq, d, dtype=f32), _rand(gen, b, h, sq, d,
                                                      dtype=f32)
    k, v = _rand(gen, b, h, sk, d, dtype=f32), _rand(gen, b, h, sk, d,
                                                     dtype=f32)
    sid_q = _f32_seg(b, sq, min(20, sq // 4)) if seg else None
    sid_kv = _f32_seg(b, sk, 0) if seg else None
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal)
    f = fa.flash_attention_bwd
    n0 = (f.f32_launches, f.f32_dkdv_launches, f.dq_launches)
    grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                               d ** -0.5, split=split)
    torch.cuda.synchronize()
    assert (f.f32_launches - n0[0], f.f32_dkdv_launches - n0[1],
            f.dq_launches - n0[2]) == ((0, 1, 1) if split else (1, 0, 0))
    refs = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=causal, segment_ids_q=sid_q,
        segment_ids_kv=sid_kv)
    for g, r in zip(grads, refs):
        assert g.dtype == f32 and g.shape == r.shape
        _close_fp32(g, r)
    if seg:
        assert not bool(grads[0][(sid_q < 0)[:, None, :].expand(
            b, h, sq)].any())


@pytest.mark.parametrize("d,split", [(64, False), (128, False), (64, True),
                                     (128, True)])
def test_flash_bwd_f32_route_is_bitwise_on_a_rerun_and_alone(gen, d, split):
    """dq, dk and dv are the same bits on a rerun (every product an fmaf in
    a fixed order, dq summed in a fixed order of key blocks) and, for one
    batch, the same bits run alone."""
    f32 = torch.float32
    b, h, s = 3, 2, 700
    q, k, v, do = (_rand(gen, b, h, s, d, dtype=f32) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    args = (None, None, True, d ** -0.5)
    got = fa._flash_bwd_cuda(q, k, v, out, lse, do, *args, split=split)
    again = fa._flash_bwd_cuda(q, k, v, out, lse, do, *args, split=split)
    one = fa._flash_bwd_cuda(q[1:2], k[1:2], v[1:2], out[1:2], lse[1:2],
                             do[1:2], *args, split=split)
    torch.cuda.synchronize()
    for g, a, o in zip(got, again, one):
        assert torch.equal(g, a)
        assert torch.equal(g[1:2], o)


@pytest.mark.parametrize("s", [1024, 4096])
def test_o0_gpt_autograd_runs_every_flash_backward_on_the_f32_route(gen, s):
    """An fp32 GPT (2 layers, h256, 4 heads: head dim 64) at s1024 (the
    single pass) and s4096 (past the gate: the split): every flash
    forward and backward launch takes the FFMA route (the split's dk/dv
    and dq both), none flash_fwd.cu's or flash_bwd.cu's; loss within 1e-5
    and gradients within 1e-4 in relative norm of the plain versions."""
    from apex_tpu_torch.models.gpt import GPT, GPTConfig
    cfg = GPTConfig(vocab_size=512, max_seq_len=s, hidden_size=256,
                    num_layers=2, num_heads=4, dtype=torch.float32)
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0))
    ids = torch.randint(0, 512, (8192 // s, s), generator=gen, device="cuda")
    labels = torch.roll(ids, -1, 1)
    params = [p for _, p in model.named_parameters()]
    f, fwd = fa.flash_attention_bwd, fa.flash_attention
    names = ("launches", "f32_launches", "dkdv_launches",
             "f32_dkdv_launches", "dq_launches", "wgmma_launches",
             "f32_dq_launches")
    n0 = [getattr(f, n) for n in names]
    fwd0 = (fwd.launches, fwd.f32_launches)
    loss = model.loss(ids, labels)
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    moved = [getattr(f, n) - a for n, a in zip(names, n0)]
    want = [0, 0, 2, 2, 2, 0, 2] if s == 4096 else [2, 2, 0, 0, 0, 0, 0]
    assert moved == want, moved
    # every forward on the FFMA route (csrc/flash_fwd_f32.cuh)
    assert (fwd.launches - fwd0[0], fwd.f32_launches - fwd0[1]) == (2, 2)
    ref_loss = model.loss(ids, labels, reference=True)
    refs = torch.autograd.grad(ref_loss, params)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * float(ref_loss)
    for g, r in zip(grads, refs):
        rel = float((g - r).norm() / r.norm().clamp_min(1e-30))
        assert rel <= 1e-4, rel


# ---------------------------------------------------------------------------
# B12's prefill regime (wgmma/TMA) and B7 (csrc/layer_norm_bwd.cu)
# ---------------------------------------------------------------------------

_SERVE_LINEARS = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]


def _device_kernels(fn, sessions=8):
    """The device kernels one call of ``fn`` launches (after one unprofiled
    call), as {name: count}. A profiler session has been seen to record no
    device kernel of a call that launched one; such an empty session is
    taken again, up to ``sessions`` times (every caller's ``fn`` launches at
    least one kernel)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA}
        if kernels:
            return kernels
    return {}


@pytest.mark.parametrize("m", [9, 16, 100, 512, 2048])
@pytest.mark.parametrize("K,N", _SERVE_LINEARS + [(1000, 1000)])
def test_fp8_matmul_prefill_matches_plain(gen, m, K, N):
    x = _rand(gen, m, K)
    q, scale = mm.quantize_weight(_rand(gen, K, N, dtype=torch.float32)
                                  * K ** -0.5)
    before = mm.fp8_dequant_matmul.launches
    y = mm.fp8_dequant_matmul(x, q, scale)
    assert mm.fp8_dequant_matmul.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (m, N)
    _close(y, mm.fp8_dequant_matmul_reference(x, q, scale), 1e-3)


@pytest.mark.parametrize("K,N", _SERVE_LINEARS)
def test_fp8_matmul_prefill_rows_bitwise_independent_and_rerun(gen, K, N):
    """A prefill-regime row is bitwise the same on a rerun and in any call
    of more than 8 rows that holds it (the plan is a function of K and N
    alone), and the call is one device launch."""
    x = _rand(gen, 512, K)
    q, scale = mm.quantize_weight(_rand(gen, K, N, dtype=torch.float32)
                                  * K ** -0.5)
    y = mm.fp8_dequant_matmul(x, q, scale)
    assert torch.equal(y, mm.fp8_dequant_matmul(x, q, scale))
    for r0 in (0, 5, 127, 300, 503):
        part = mm.fp8_dequant_matmul(x[r0:r0 + 9].contiguous(), q, scale)
        assert torch.equal(part, y[r0:r0 + 9]), r0
    assert torch.equal(mm.fp8_dequant_matmul(x[100:230].contiguous(), q,
                                             scale), y[100:230])
    kernels = _device_kernels(lambda: mm.fp8_dequant_matmul(x, q, scale))
    assert sum(kernels.values()) == 1 and "fp8_mm_prefill_kernel" in \
        next(iter(kernels)), kernels


def _ln_bwd_check(gen, n, h, x_dtype, p_dtype, dy_dtype=None):
    dy_dtype = x_dtype if dy_dtype is None else dy_dtype
    x = _rand(gen, n, h, dtype=torch.float32).mul(2).add(0.5).to(x_dtype)
    w = (1 + 0.1 * _rand(gen, h, dtype=torch.float32)).to(p_dtype)
    dy = _rand(gen, n, h, dtype=torch.float32).to(dy_dtype)
    got = ln.layer_norm_bwd(x, w, dy, (h,), 1e-5)
    torch.cuda.synchronize()
    ref = ln.layer_norm_bwd_reference(x, w, dy, (h,), 1e-5)
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
           torch.float32: 2.0 ** -22}
    assert [g.dtype for g in got] == [r.dtype for r in ref]
    if n:
        d = (got[0].float() - ref[0].float()).abs()
        assert bool((d <= ref[0].float().abs() * 2 * ulp[x_dtype]
                     + 1e-5 * float(ref[0].float().abs().max()) + 1e-6
                     ).all()), float(d.max())
    for g, r in zip(got[1:], ref[1:]):
        d = (g.float() - r.float()).abs()
        assert bool((d <= r.float().abs() * ulp[p_dtype]
                     + 1e-4 * float(r.float().abs().max()) + 1e-6
                     ).all()), float(d.max())
    return x, w, dy, got


@pytest.mark.parametrize("x_dtype,p_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float16, torch.float32), (torch.float32, torch.float32)])
@pytest.mark.parametrize("h", [64, 1000, 1024, 4096, 16384])
@pytest.mark.parametrize("n", [0, 1, 7, 8192, 8193])
def test_layer_norm_bwd_kernel_shapes_match_plain(gen, n, h, x_dtype,
                                                  p_dtype):
    """Both kernels (a warp a row to h 1024, a block a row past it) at the
    Triton kernel's whole range: masked tails, n 0, rows past a block's
    share; ``.block_rows_launches`` names the kernel that ran."""
    b0 = ln.layer_norm_bwd.block_rows_launches
    _ln_bwd_check(gen, n, h, x_dtype, p_dtype)
    assert ln.layer_norm_bwd.block_rows_launches == b0 + (h > 1024)


@pytest.mark.parametrize("n,h", [(40, 100), (8192, 1024), (9, 2000)])
def test_layer_norm_bwd_mixed_dtypes_match_plain(gen, n, h):
    """x, dy and the parameters of three dtypes (dy fp32 beside a bf16 x,
    as a bf16 LayerNorm with fp32 output gives it)."""
    _ln_bwd_check(gen, n, h, torch.bfloat16, torch.float16, torch.float32)


@pytest.mark.parametrize("h", [1024, 4096])
def test_layer_norm_bwd_is_one_launch_and_bitwise_on_a_rerun(gen, h):
    x, w, dy, got = _ln_bwd_check(gen, 8192, h, torch.bfloat16,
                                  torch.bfloat16)
    again = ln.layer_norm_bwd(x, w, dy, (h,), 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    kernels = _device_kernels(lambda: ln.layer_norm_bwd(x, w, dy, (h,),
                                                        1e-5))
    assert sum(kernels.values()) == 1 and "ln_bwd_" in next(iter(kernels)), \
        kernels


# ---------------------------------------------------------------------------
# the additive bias in the forward and the single pass (bias variants)
# ---------------------------------------------------------------------------

def _bias_inputs(gen, dtype, d, bdims, b, h, sq, sk, seg, dead):
    """q, k, v, do, a bias of ``bdims`` (2 x randn, a fifth of it -inf, key
    0 finite in every row, row ``dead`` -inf everywhere) and segment ids
    with padding (or None)."""
    q, do = (_rand(gen, b, h, sq, d, dtype=dtype) for _ in range(2))
    k, v = (_rand(gen, b, h, sk, d, dtype=dtype) for _ in range(2))
    bias = 2 * _rand(gen, *bdims, sq, sk, dtype=torch.float32)
    bias[torch.rand(bias.shape, generator=gen, device="cuda") < 0.2] = \
        float("-inf")
    bias[..., 0] = 0.0
    if dead is not None:
        bias[:, :, dead] = float("-inf")
    sid_q = sid_kv = None
    if seg:
        sid_q = torch.zeros(b, sq, dtype=torch.int32, device="cuda")
        sid_q[-1, sq - 5:] = -1
        sid_kv = torch.zeros(b, sk, dtype=torch.int32, device="cuda")
        sid_kv[0, sk - 9:] = -1
    return q, k, v, do, bias, sid_q, sid_kv


@pytest.mark.parametrize("dtype,d,bdims,b,h,sq,sk,causal,seg,dead", [
    (_BF, 64, (1, 1), 2, 4, 512, 512, False, False, 7),
    (_F16, 64, (1, 4), 2, 4, 300, 700, True, False, None),
    (_BF, 128, (2, 1), 2, 4, 257, 513, False, True, None),
    (_F16, 128, (2, 4), 2, 4, 640, 333, False, False, 100),
    (_BF, 64, (3, 2), 3, 2, 128, 129, True, True, None),
    (_BF, 80, (1, 1), 1, 2, 96, 77, False, False, 0),     # padded head dim
])
@pytest.mark.parametrize("rows", [64, 128])
def test_flash_bias_variants_match_plain(gen, dtype, d, bdims, b, h, sq,
                                         sk, causal, seg, dead, rows):
    q, k, v, do, bias, sid_q, sid_kv = _bias_inputs(
        gen, dtype, d, bdims, b, h, sq, sk, seg, dead)
    scale = d ** -0.5
    f, g = fa.flash_attention, fa.flash_attention_bwd
    n0 = (f.bias_launches, g.bias_launches)
    out, lse = fa._flash_fwd_cuda(q, k, v, sid_q, sid_kv, causal, scale,
                                  block_rows=rows, bias=bias)
    grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                               scale, split=False, bias=bias)
    torch.cuda.synchronize()
    assert (f.bias_launches - n0[0], g.bias_launches - n0[1]) == (1, 1)
    ref, ref_lse = fa.flash_attention_reference(
        q, k, v, causal=causal, segment_ids_q=sid_q, segment_ids_kv=sid_kv,
        scale=scale, bias=bias)
    _close(out, ref, 4e-3)
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    rgrads = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=causal, segment_ids_q=sid_q,
        segment_ids_kv=sid_kv, scale=scale, bias=bias)
    for name, got, r in zip(("dq", "dk", "dv"), grads, rgrads):
        assert bool(torch.isfinite(got.float()).all()), name
        _close_grad(got, r, name)
    if dead is not None:
        assert float(out[:, :, dead].abs().max()) == 0.0
        assert bool((lse[:, :, dead] == -1e30).all())
        assert float(grads[0][:, :, dead].abs().max()) == 0.0


def test_flash_bias_is_bitwise_on_a_rerun(gen):
    """At the train-mha18 path's attention: the future mask as a [1, 1, s,
    s] bias, key padding as segment ids."""
    b, h, s, d = 4, 16, 512, 64
    q, k, v, do = (_rand(gen, b, h, s, d) for _ in range(4))
    bias = torch.triu(torch.full((s, s), float("-inf"), device="cuda"),
                      1)[None, None]
    sid_kv = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    sid_kv[1, 400:] = -1
    seg = (torch.zeros_like(sid_kv), sid_kv)
    one = fa.flash_attention_fwd(q, k, v, *seg, False, bias=bias)
    two = fa.flash_attention_fwd(q, k, v, *seg, False, bias=bias)
    g1 = fa.flash_attention_bwd(q, k, v, *one, do, *seg, False, bias=bias)
    g2 = fa.flash_attention_bwd(q, k, v, *one, do, *seg, False, bias=bias)
    assert all(torch.equal(a, b_) for a, b_ in zip(one + g1, two + g2))


@pytest.mark.parametrize("d", [64, 128])
def test_flash_bias_positions_are_bitwise(gen, d):
    """One-hot bias rows (0 at key pi(q), a permutation per (batch, head),
    -inf elsewhere): out is v[pi(q)] and dv is do permuted, bit for bit."""
    b, h, s = 2, 3, 256
    q, k, v, do = (_rand(gen, b, h, s, d) for _ in range(4))
    perm = torch.stack([torch.randperm(s, generator=gen, device="cuda")
                        for _ in range(b * h)]).view(b, h, s)
    bias = torch.full((b, h, s, s), float("-inf"), device="cuda")
    bias.scatter_(3, perm[..., None], 0.0)
    out, lse = fa.flash_attention_fwd(q, k, v, bias=bias)
    idx = perm[..., None].expand(b, h, s, d)
    assert torch.equal(out, v.gather(2, idx))
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, bias=bias)
    assert torch.equal(dv, torch.empty_like(do).scatter_(2, idx, do))


def test_flash_bias_refuses_the_unported_routes_on_the_card(gen):
    """s640 d64 with a bias splits, and the split takes the bias, with
    dropout too (one launch each of the dk/dv and dq variants with both);
    the single pass takes both (s448 d64, under the gate: one launch of its
    variant with both); the fp32 FFMA route takes the bias alone (its
    forward's and single pass's bias variants) and with dropout (their
    variants with both), and frag.cuh refuses the bias, with dropout or
    without, before any launch."""
    qs = _rand(gen, 1, 1, 640, 64).requires_grad_()
    bias = torch.zeros(1, 1, 640, 640, device="cuda")
    g = fa.flash_attention_bwd
    n0 = fa.flash_attention.launches

    def counts():
        return (g.launches, g.bias_dkdv_launches, g.bias_dq_launches,
                g.bias_dropout_dkdv_launches, g.bias_dropout_dq_launches)

    s0 = counts()
    fa.flash_attention(qs, qs, qs, bias=bias).float().sum().backward()
    torch.cuda.synchronize()
    assert counts() == (s0[0], s0[1] + 1, s0[2] + 1, s0[3], s0[4])
    assert bool(torch.isfinite(qs.grad).all())
    qs.grad = None
    fa.flash_attention(qs, qs, qs, bias=bias, dropout_rate=0.1,
                       dropout_seed=5).float().sum().backward()
    torch.cuda.synchronize()
    assert counts() == (s0[0], s0[1] + 1, s0[2] + 1, s0[3] + 1, s0[4] + 1)
    assert bool(torch.isfinite(qs.grad).all())
    q448 = _rand(gen, 1, 1, 448, 64).requires_grad_()
    n1 = g.bias_dropout_fused_launches
    fa.flash_attention(q448, q448, q448,
                       bias=torch.zeros(1, 1, 448, 448, device="cuda"),
                       dropout_rate=0.1,
                       dropout_seed=5).float().sum().backward()
    torch.cuda.synchronize()
    assert g.bias_dropout_fused_launches == n1 + 1
    assert counts() == (s0[0] + 1, s0[1] + 1, s0[2] + 1, s0[3] + 1,
                        s0[4] + 1)
    q32 = _rand(gen, 1, 2, 64, 64, dtype=torch.float32).requires_grad_()
    b64 = torch.zeros(1, 1, 64, 64, device="cuda")
    n1 = (fa.flash_attention.f32_bias_launches, g.f32_bias_launches)
    fa.flash_attention(q32, q32, q32, bias=b64).sum().backward()
    torch.cuda.synchronize()
    assert (fa.flash_attention.f32_bias_launches - n1[0],
            g.f32_bias_launches - n1[1]) == (1, 1)
    q32.grad = None
    n1 = (fa.flash_attention.f32_bias_dropout_launches,
          g.f32_bias_dropout_launches)
    fa.flash_attention(q32, q32, q32, bias=b64, dropout_rate=0.1,
                       dropout_seed=5).sum().backward()
    torch.cuda.synchronize()
    assert (fa.flash_attention.f32_bias_dropout_launches - n1[0],
            g.f32_bias_dropout_launches - n1[1]) == (1, 1)
    assert bool(torch.isfinite(q32.grad).all())
    qd = _rand(gen, 1, 2, 64, 32)
    for kw in ({}, dict(dropout_rate=0.1, dropout_seed=5)):
        with pytest.raises(NotImplementedError, match="frag.cuh"):
            fa.flash_attention(qd, qd, qd, bias=b64, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 5


# ---------------------------------------------------------------------------
# the additive bias in the split (B3, B4 bias variants)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,bdims,b,h,sq,sk,causal,seg,dead", [
    (_BF, 64, (1, 1), 2, 4, 512, 512, False, False, 7),   # unmasked tiles
    (_F16, 64, (1, 4), 2, 4, 300, 700, True, False, None),
    (_BF, 128, (2, 1), 2, 4, 257, 513, False, True, None),
    (_F16, 128, (2, 4), 2, 4, 640, 333, False, False, 100),
    (_BF, 64, (3, 2), 3, 2, 128, 129, True, True, None),
    (_F16, 128, (1, 1), 1, 8, 1024, 1024, False, False, 3),
])
def test_flash_split_bias_variants_match_plain(gen, dtype, d, bdims, b, h,
                                               sq, sk, causal, seg, dead):
    """Each kernel of the split with a bias against its plain version (dq
    with the delta it folds in, dk/dv from that delta); a dead row's dq
    exactly 0; a rerun bitwise."""
    q, k, v, do, bias, sid_q, sid_kv = _bias_inputs(
        gen, dtype, d, bdims, b, h, sq, sk, seg, dead)
    scale = d ** -0.5
    kw = dict(causal=causal, segment_ids_q=sid_q, segment_ids_kv=sid_kv,
              scale=scale, bias=bias)
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal, scale,
                                      bias=bias)
    g = fa.flash_attention_bwd
    n0 = (g.launches, g.bias_dkdv_launches, g.bias_dq_launches)
    grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                               scale, split=True, bias=bias)
    again = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                               scale, split=True, bias=bias)
    torch.cuda.synchronize()
    assert (g.launches, g.bias_dkdv_launches, g.bias_dq_launches) == (
        n0[0], n0[1] + 2, n0[2] + 2)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    rdq, rdelta = fa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw)
    rdk, rdv = fa.flash_bwd_dkdv_reference(q, k, v, lse, rdelta, do, **kw)
    for name, got, r in zip(("dq", "dk", "dv"), grads, (rdq, rdk, rdv)):
        assert bool(torch.isfinite(got.float()).all()), name
        _close_grad(got, r, name)
    if dead is not None:
        assert float(grads[0][:, :, dead].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,d,sq,sk", [(_BF, 64, 256, 321),
                                           (_F16, 128, 300, 512)])
def test_flash_split_bias_positions_are_bitwise(gen, dtype, d, sq, sk):
    """One-hot bias rows (0 at key pi(q) of an injective map of the queries
    into the keys, one per (batch, head)), v = e_0 and a zero output (the
    folded delta 0): dv is do scattered to pi(q), dk is do[q, 0] q scale
    there and dq do[q, 0] k[pi(q)] scale, exact products, bit for bit."""
    b, h, scale = 2, 3, 0.125
    q, do = (_rand(gen, b, h, sq, d, dtype=dtype) for _ in range(2))
    k = _rand(gen, b, h, sk, d, dtype=dtype)
    v = torch.zeros(b, h, sk, d, device="cuda", dtype=dtype)
    v[..., 0] = 1
    pi = torch.stack([torch.randperm(sk, generator=gen, device="cuda")[:sq]
                      for _ in range(b * h)]).view(b, h, sq)
    bias = torch.full((b, h, sq, sk), float("-inf"), device="cuda")
    bias.scatter_(3, pi[..., None], 0.0)
    _, lse = fa.flash_attention_fwd(q, k, v, scale=scale, bias=bias)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
    args = (q, k, v, do, lse, delta, None, None, False, scale,
            fa._mixed_rounds(q, k, do))
    bop = fa._bias_operand(bias, b, h, sq, sk, q.device, scale)
    dq = fa._flash_dq_cuda(*args, out=torch.zeros_like(q), bias=bop)
    dk, dv = fa._flash_dkdv_cuda(*args, bias=bop)
    idx = pi[..., None].expand(b, h, sq, d)
    d0 = do[..., :1].float()
    assert float(delta.abs().max()) == 0.0
    assert torch.equal(dv, torch.zeros_like(v).scatter_(2, idx, do))
    assert torch.equal(dk, torch.zeros_like(k).scatter_(
        2, idx, (d0 * q.float() * scale).to(dtype)))
    assert torch.equal(dq, (d0 * k.float().gather(2, idx) * scale).to(dtype))


# ---------------------------------------------------------------------------
# the bias with dropout (B1's, B3's and B4's variants with both)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,bdims,b,h,sq,sk,causal,seg,dead", [
    (_BF, 64, (1, 1), 2, 4, 512, 512, False, False, 7),   # unmasked tiles
    (_F16, 64, (1, 4), 2, 4, 300, 700, True, False, None),
    (_BF, 128, (2, 1), 2, 4, 257, 513, False, True, None),
    (_F16, 128, (2, 4), 2, 4, 640, 333, False, False, 100),
    (_BF, 64, (3, 2), 3, 2, 128, 129, True, True, None),
    (_F16, 128, (1, 1), 1, 8, 1024, 1024, True, False, 3),
])
def test_flash_bias_dropout_variants_match_plain(gen, dtype, d, bdims, b, h,
                                                 sq, sk, causal, seg, dead):
    """The forward (both block heights) and each kernel of the split with
    a bias and dropout 0.1 against their plain versions with the same bias
    and seed (dq with the delta it folds in from the dropped output, dk/dv
    from that delta); a dead row's output and dq exactly 0; each bitwise on
    a rerun; the counters of the variants with both alone move."""
    q, k, v, do, bias, sid_q, sid_kv = _bias_inputs(
        gen, dtype, d, bdims, b, h, sq, sk, seg, dead)
    scale, seed = d ** -0.5, 1234
    kw = dict(causal=causal, segment_ids_q=sid_q, segment_ids_kv=sid_kv,
              scale=scale, bias=bias, dropout_rate=0.1, dropout_seed=seed)
    f, g = fa.flash_attention, fa.flash_attention_bwd

    def counts():
        return (f.bias_dropout_launches, g.bias_dropout_dkdv_launches,
                g.bias_dropout_dq_launches, f.bias_launches,
                f.dropout_launches, g.bias_dkdv_launches,
                g.dropout_dkdv_launches, g.launches)

    n0 = counts()
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    for rows in (64, 128):
        out, lse = fa._flash_fwd_cuda(q, k, v, sid_q, sid_kv, causal, scale,
                                      block_rows=rows, bias=bias,
                                      dropout_rate=0.1, dropout_seed=seed)
        again = fa._flash_fwd_cuda(q, k, v, sid_q, sid_kv, causal, scale,
                                   block_rows=rows, bias=bias,
                                   dropout_rate=0.1, dropout_seed=seed)
        torch.cuda.synchronize()
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        _close(out, ref, 4e-3)
        assert float((lse - ref_lse).abs().max()) <= 1e-3
        if dead is not None:
            assert float(out[:, :, dead].abs().max()) == 0.0
            assert bool((lse[:, :, dead] == -1e30).all())
    grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                               scale, split=True, bias=bias,
                               dropout_rate=0.1, dropout_seed=seed)
    again = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                               scale, split=True, bias=bias,
                               dropout_rate=0.1, dropout_seed=seed)
    torch.cuda.synchronize()
    assert tuple(a - b_ for a, b_ in zip(counts(), n0)) == (4, 2, 2, 0, 0, 0,
                                                            0, 0)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    rdq, rdelta = fa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw)
    rdk, rdv = fa.flash_bwd_dkdv_reference(q, k, v, lse, rdelta, do, **kw)
    for name, got, r in zip(("dq", "dk", "dv"), grads, (rdq, rdk, rdv)):
        assert bool(torch.isfinite(got.float()).all()), name
        _close_grad(got, r, name)
    if dead is not None:
        assert float(grads[0][:, :, dead].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,d", [(_BF, 64), (_F16, 128)])
@pytest.mark.parametrize("seed", [5, -3])
def test_flash_bias_dropout_keep_pattern_and_positions_are_bitwise(
        gen, dtype, d, seed):
    """Rate 0.5. The keep pattern, under a bias in [-1, 1) everywhere (p >
    0, no fp16 underflow): the forward with q = k = 0 and v the identity
    over sk = d keys is zero exactly where an element is dropped; the
    split's dk/dv with q = 0 and do = I over sq = d rows gives dv = the
    dropped p transposed; its dq with k = I over sk = d keys and a zero
    output is zero exactly where a key is dropped.
    The positions, through one-hot bias rows (0 at key pi(q) of an
    injective map into sk > sq keys, -inf elsewhere), v = e_0 and a zero
    output: p is 1 at (q, pi(q)), so out is 2 v[pi(q)] where kept, dv 2
    do[q] at pi(q), dk 2 do[q, 0] q scale there and dq 2 do[q, 0] k[pi(q)]
    scale, each 0 where dropped: exact products, bit for bit."""
    b, h, s = 2, 3, 333
    half = fa._dropout_args(0.5, seed)
    eye = torch.eye(d, device="cuda", dtype=dtype).expand(b, h, d, d)
    eye = eye.contiguous()
    rounds = fa._mixed_rounds(eye, eye, eye)

    def unit(*shape):           # a bias in [-1, 1)
        return 2 * torch.rand(*shape, generator=gen, device="cuda") - 1

    # the forward: q = k = 0, v = I, sk = d
    q = torch.zeros(b, h, s, d, device="cuda", dtype=dtype)
    k = torch.zeros(b, h, d, d, device="cuda", dtype=dtype)
    bias = unit(1, h, s, d)
    out, _ = fa.flash_attention_fwd(q, k, eye, None, None, False, 1.0,
                                    0.5, seed, bias=bias)
    keep = fa.dropout_keep_reference(seed, b, h, s, d, 0.5, device="cuda")
    assert torch.equal(out != 0, keep)
    # dk/dv: q = 0, do = I over sq = d rows
    k, v = (_rand(gen, b, h, s, d, dtype=dtype) for _ in range(2))
    q = torch.zeros(b, h, d, d, device="cuda", dtype=dtype)
    bias = unit(b, 1, d, s)
    _, lse = fa.flash_attention_fwd(q, k, v, None, None, False, 1.0,
                                    bias=bias)
    zero = torch.zeros(b, h, d, dtype=torch.float32, device="cuda")
    bop = fa._bias_operand(bias, b, h, d, s, q.device, 1.0)
    _, dv = fa._flash_dkdv_cuda(q, k, v, eye, lse, zero, None, None, False,
                                1.0, rounds, dropout=half, bias=bop)
    keep = fa.dropout_keep_reference(seed, b, h, d, s, 0.5, device="cuda")
    assert torch.equal(dv != 0, keep.transpose(-1, -2))
    # dq: k = I over sk = d keys, out = 0
    q, v, do = (_rand(gen, b, h, n, d, dtype=dtype) for n in (s, d, s))
    bias = unit(1, 1, s, d)
    _, lse = fa.flash_attention_fwd(q, eye, v, None, None, False, 1.0,
                                    bias=bias)
    delta = torch.empty(b, h, s, dtype=torch.float32, device="cuda")
    bop = fa._bias_operand(bias, b, h, s, d, q.device, 1.0)
    dq = fa._flash_dq_cuda(q, eye, v, do, lse, delta, None, None, False,
                           1.0, rounds, out=torch.zeros_like(q),
                           dropout=half, bias=bop)
    keep = fa.dropout_keep_reference(seed, b, h, s, d, 0.5, device="cuda")
    assert float(delta.abs().max()) == 0.0
    assert torch.equal(dq != 0, keep)
    # the positions
    sq, sk, scale = 300, 513, 0.125
    q, do = (_rand(gen, b, h, sq, d, dtype=dtype) for _ in range(2))
    k = _rand(gen, b, h, sk, d, dtype=dtype)
    v = torch.zeros(b, h, sk, d, device="cuda", dtype=dtype)
    v[..., 0] = 1
    pi = torch.stack([torch.randperm(sk, generator=gen, device="cuda")[:sq]
                      for _ in range(b * h)]).view(b, h, sq)
    bias = torch.full((b, h, sq, sk), float("-inf"), device="cuda")
    bias.scatter_(3, pi[..., None], 0.0)
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, False, scale,
                                      0.5, seed, bias=bias)
    kept = fa.dropout_keep_reference(seed, b, h, sq, sk, 0.5,
                                     device="cuda").gather(3, pi[..., None])
    idx = pi[..., None].expand(b, h, sq, d)
    two = torch.where(kept, 2.0, 0.0)
    assert torch.equal(out, (two * v.float().gather(2, idx)).to(dtype))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
    args = (q, k, v, do, lse, delta, None, None, False, scale, rounds)
    bop = fa._bias_operand(bias, b, h, sq, sk, q.device, scale)
    dq = fa._flash_dq_cuda(*args, out=torch.zeros_like(q), dropout=half,
                           bias=bop)
    dk, dv = fa._flash_dkdv_cuda(*args, dropout=half, bias=bop)
    d0 = two * do[..., :1].float()
    assert torch.equal(dv, torch.zeros_like(v).scatter_(
        2, idx, (two * do.float()).to(dtype)))
    assert torch.equal(dk, torch.zeros_like(k).scatter_(
        2, idx, (d0 * q.float() * scale).to(dtype)))
    assert torch.equal(dq, (d0 * k.float().gather(2, idx) * scale).to(dtype))


# ---------------------------------------------------------------------------
# the single pass with the bias and dropout (B2's variant with both), and
# attention dropout on the fp32 FFMA route (B1's and B2's dropout variants)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,bdims,b,h,sq,sk,causal,seg,dead", [
    (_BF, 64, (1, 1), 2, 4, 448, 448, False, False, 7),   # unmasked tiles
    (_F16, 64, (1, 4), 2, 4, 300, 700, True, False, None),
    (_BF, 128, (2, 1), 2, 4, 257, 513, False, True, None),
    (_F16, 128, (2, 4), 2, 4, 384, 333, False, False, 100),
    (_BF, 64, (3, 2), 3, 2, 128, 129, True, True, None),
    (_F16, 128, (1, 1), 1, 8, 1024, 1024, True, False, 3),
    (_BF, 80, (1, 1), 1, 2, 96, 77, False, False, 0),     # padded head dim
])
def test_flash_single_pass_bias_dropout_matches_plain(gen, dtype, d, bdims,
                                                      b, h, sq, sk, causal,
                                                      seg, dead):
    """The single pass's variant with both (forced: the gate splits some
    of these shapes) with a bias and dropout 0.1 against the plain
    backward with the same bias and seed; dq, dk and dv bitwise on a rerun
    (dq through the ordered turns); a dead row's dq exactly 0; the counter
    of the single pass with both alone moves."""
    q, k, v, do, bias, sid_q, sid_kv = _bias_inputs(
        gen, dtype, d, bdims, b, h, sq, sk, seg, dead)
    scale, seed = d ** -0.5, 4321
    drop = dict(dropout_rate=0.1, dropout_seed=seed)
    g = fa.flash_attention_bwd
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal, scale,
                                      bias=bias, **drop)

    def counts():
        return (g.bias_dropout_fused_launches, g.bias_launches,
                g.dropout_launches, g.bias_dropout_dkdv_launches,
                g.bias_dropout_dq_launches, g.launches)

    n0 = counts()
    grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                               scale, split=False, bias=bias, **drop)
    again = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                               scale, split=False, bias=bias, **drop)
    torch.cuda.synchronize()
    assert tuple(a - b_ for a, b_ in zip(counts(), n0)) == (2, 0, 0, 0, 0,
                                                            2)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    ref = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=causal, segment_ids_q=sid_q,
        segment_ids_kv=sid_kv, scale=scale, bias=bias, **drop)
    for name, got, r in zip(("dq", "dk", "dv"), grads, ref):
        assert got.dtype == dtype and bool(torch.isfinite(got.float()).all())
        _close_grad(got, r, name)
    if dead is not None:
        assert float(grads[0][:, :, dead].abs().max()) == 0.0


_F32_DROPOUT_CASES = [
    (2, 3, 65, 65, 64, True, True, 0.1, 1234),
    (1, 2, 300, 129, 128, True, False, 0.3, -7),
    (1, 2, 129, 300, 64, False, True, 0.5, 2 ** 31 - 1),
    (2, 2, 1000, 1003, 64, True, True, 0.1, 0),
    (1, 2, 257, 257, 80, False, False, 0.2, 99),          # d 80 -> 128
    (1, 2, 300, 90, 128, True, True, 0.9, -2 ** 31),      # rows with no key
]


@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg,rate,seed",
                         _F32_DROPOUT_CASES)
def test_flash_f32_dropout_route_matches_plain(gen, b, h, sq, sk, d, causal,
                                               seg, rate, seed):
    """fp32 with dropout on the FFMA route: the forward's and the single
    pass's dropout variants against the plain versions with the same seed
    (out 1e-5 of the largest, lse 1e-5 relative, gradients 1e-4); out,
    lse, dq, dk and dv bitwise on a rerun, another seed another output,
    padding rows' dq exactly zero; their dropout counters move, and the
    FFMA counters without them as often."""
    f32 = torch.float32
    q, do = _rand(gen, b, h, sq, d, dtype=f32), _rand(gen, b, h, sq, d,
                                                      dtype=f32)
    k, v = _rand(gen, b, h, sk, d, dtype=f32), _rand(gen, b, h, sk, d,
                                                     dtype=f32)
    sid_q = _f32_seg(b, sq, min(20, sq // 4)) if seg else None
    sid_kv = _f32_seg(b, sk, 0) if seg else None
    drop = dict(dropout_rate=rate, dropout_seed=seed)
    f, g = fa.flash_attention, fa.flash_attention_bwd

    def counts():
        return (f.f32_dropout_launches, f.f32_launches,
                g.f32_dropout_launches, g.f32_launches, g.dropout_launches)

    n0 = counts()
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal, **drop)
    again = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal, **drop)
    other = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal,
                                   dropout_rate=rate, dropout_seed=seed ^ 1)
    grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                               d ** -0.5, split=False, **drop)
    grads2 = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                                d ** -0.5, split=False, **drop)
    torch.cuda.synchronize()
    assert tuple(a - b_ for a, b_ in zip(counts(), n0)) == (3, 3, 2, 2, 0)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert not torch.equal(out, other[0])
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, grads2))
    kw = dict(causal=causal, segment_ids_q=sid_q, segment_ids_kv=sid_kv,
              **drop)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    _close_fp32(out, ref, 1e-5)
    live = ref_lse > -1e29
    if bool(live.any()):
        rel = (lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)
        assert float(rel[live].max()) <= 1e-5
    ref_grads = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                 **kw)
    for got, r in zip(grads, ref_grads):
        assert got.dtype == f32
        _close_fp32(got, r)
    if seg:
        assert not bool(grads[0][(sid_q < 0)[:, None, :].expand(b, h,
                                                                 sq)].any())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("seed", [5, -3])
def test_flash_f32_dropout_keep_pattern_is_the_plain_mask(gen, d, seed):
    """Rate 0.5 on the FFMA route, no mask. The forward with q = k = 0 and
    v = I over sk = d keys: out[q, k] is 2 / d where the key is kept and
    exactly 0 where it is dropped. The single pass with q = 0 (p = 1 / s
    everywhere) and do = I over sq = d rows: dv = the dropped p
    transposed. Both zero patterns are the plain mask bit for bit."""
    f32, b, h, s = torch.float32, 2, 3, 333
    eye = torch.eye(d, device="cuda").expand(b, h, d, d).contiguous()
    q = torch.zeros(b, h, s, d, device="cuda")
    k = torch.zeros(b, h, d, d, device="cuda")
    out, _ = fa.flash_attention_fwd(q, k, eye, None, None, False, 1.0, 0.5,
                                    seed)
    keep = fa.dropout_keep_reference(seed, b, h, s, d, 0.5, device="cuda")
    assert torch.equal(out != 0, keep)
    assert torch.equal(out[keep], torch.full_like(out[keep], 2.0 / d))
    k, v = (_rand(gen, b, h, s, d, dtype=f32) for _ in range(2))
    q = torch.zeros(b, h, d, d, device="cuda")
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, False, 1.0, 0.5,
                                      seed)
    _, _, dv = fa._flash_bwd_cuda(q, k, v, out, lse, eye, None, None, False,
                                  1.0, split=False, dropout_rate=0.5,
                                  dropout_seed=seed)
    keep = fa.dropout_keep_reference(seed, b, h, d, s, 0.5, device="cuda")
    assert torch.equal(dv != 0, keep.transpose(-1, -2))


def test_multihead_attn_modules_run_the_bias_kernels(gen):
    """SelfMultiheadAttn with an additive mask and key padding, and
    EncdecMultiheadAttn at sq != sk, in bf16 on the card: every attention
    on the bias variants, the loss and gradients within the train step's
    limits of the plain versions (``reference=True``)."""
    from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                       SelfMultiheadAttn)
    e, heads, s, b = 256, 4, 128, 3
    m = SelfMultiheadAttn(e, heads, use_bias=True, include_norm_add=True,
                          generator=torch.Generator().manual_seed(0))
    m = m.bfloat16()
    x = _rand(gen, s, b, e)
    kpm = torch.zeros(b, s, dtype=torch.bool, device="cuda")
    kpm[1, 100:] = True
    mask = torch.triu(torch.full((s, s), float("-inf"), device="cuda"), 1)
    n0 = (fa.flash_attention.bias_launches,
          fa.flash_attention_bwd.bias_launches)
    y = m(x, key_padding_mask=kpm, attn_mask=mask, is_training=False)
    grads = torch.autograd.grad(y.float().square().mean(),
                                list(m.parameters()))
    yr = m(x, key_padding_mask=kpm, attn_mask=mask, is_training=False,
           reference=True)
    refs = torch.autograd.grad(yr.float().square().mean(),
                               list(m.parameters()))
    assert (fa.flash_attention.bias_launches - n0[0],
            fa.flash_attention_bwd.bias_launches - n0[1]) == (1, 1)

    def rel(a, r):
        return float((a.float() - r.float()).norm()
                     / r.float().norm().clamp_min(1e-30))

    assert rel(y, yr) <= 1e-2
    for g, r in zip(grads, refs):
        assert rel(g, r) <= 3e-2
    enc = EncdecMultiheadAttn(e, heads, generator=torch.Generator()
                              .manual_seed(1)).bfloat16()
    xk = _rand(gen, 2 * s, b, e)
    bias = _rand(gen, b, 1, s, 2 * s, dtype=torch.float32)
    out = enc(x, xk, attn_mask=bias, is_training=False)
    ref = enc(x, xk, attn_mask=bias, is_training=False, reference=True)
    assert rel(out, ref) <= 1e-2


# ---------------------------------------------------------------------------
# the fp32 FFMA route: dropout in its split (B3's and B4's dropout
# variants) and the additive bias in its forward, single pass and split
# (B1's, B2's, B3's and B4's bias variants)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,sq,sk,d,causal,seg,rate,seed",
                         _F32_DROPOUT_CASES)
def test_flash_f32_split_dropout_matches_plain(gen, b, h, sq, sk, d, causal,
                                               seg, rate, seed):
    """The FFMA split's dropout variants (dk/dv, then dq on the scratch the
    dk/dv call transposed into) against the plain split with the same seed
    (1e-4 of the largest value and in relative norm); dq, dk and dv bitwise
    on a rerun, padding rows' dq exactly 0; the split's dropout counters
    move beside its FFMA counters, and no single pass runs."""
    f32 = torch.float32
    q, do = (_rand(gen, b, h, sq, d, dtype=f32) for _ in range(2))
    k, v = (_rand(gen, b, h, sk, d, dtype=f32) for _ in range(2))
    sid_q = _f32_seg(b, sq, min(20, sq // 4)) if seg else None
    sid_kv = _f32_seg(b, sk, 0) if seg else None
    drop = dict(dropout_rate=rate, dropout_seed=seed)
    g = fa.flash_attention_bwd

    def counts():
        return (g.f32_dropout_dkdv_launches, g.f32_dropout_dq_launches,
                g.f32_dkdv_launches, g.f32_dq_launches, g.launches)

    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal, **drop)
    n0 = counts()
    grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                               d ** -0.5, split=True, **drop)
    again = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                               d ** -0.5, split=True, **drop)
    torch.cuda.synchronize()
    assert tuple(a - b_ for a, b_ in zip(counts(), n0)) == (2, 2, 2, 2, 0)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    ref = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=causal, segment_ids_q=sid_q,
        segment_ids_kv=sid_kv, **drop)
    for got, r in zip(grads, ref):
        _close_fp32(got, r)
    if seg:
        assert not bool(grads[0][(sid_q < 0)[:, None, :].expand(b, h,
                                                                 sq)].any())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("seed", [5, -3])
def test_flash_f32_split_dropout_keep_pattern_is_the_plain_mask(gen, d,
                                                                seed):
    """Rate 0.5, no mask, through the split's two kernels. dk/dv with q = 0
    (p = 1 / s everywhere) and do = I over sq = d rows: dv = the dropped p
    transposed. dq over sk = d keys, key 0 = e_0 and the others 0, v = I,
    do = 1 and delta 0: dp = 1 everywhere, so ds = p keep 2 and dq[q] =
    ds[q, 0] e_0, nonzero in its first column exactly where key 0 is kept.
    Both zero patterns are the plain mask bit for bit."""
    f32, b, h, s = torch.float32, 2, 3, 333
    rounds = fa._NO_ROUNDS
    half = fa._dropout_args(0.5, seed)
    eye = torch.eye(d, device="cuda").expand(b, h, d, d).contiguous()
    k, v = (_rand(gen, b, h, s, d, dtype=f32) for _ in range(2))
    q = torch.zeros(b, h, d, d, device="cuda")
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, False, 1.0, 0.5,
                                      seed)
    delta = torch.zeros(b, h, d, device="cuda")
    _, dv = fa._flash_dkdv_cuda(q, k, v, eye, lse, delta, None, None, False,
                                1.0, rounds, dropout=half)
    keep = fa.dropout_keep_reference(seed, b, h, d, s, 0.5, device="cuda")
    assert torch.equal(dv != 0, keep.transpose(-1, -2))
    q = _rand(gen, b, h, s, d, dtype=f32)
    kk = torch.zeros(b, h, d, d, device="cuda")
    kk[:, :, 0, 0] = 1.0
    do = torch.ones(b, h, s, d, device="cuda")
    _, lse = fa.flash_attention_fwd(q, kk, eye, None, None, False, 1.0)
    delta = torch.zeros(b, h, s, device="cuda")
    dq = fa._flash_dq_cuda(q, kk, eye, do, lse, delta, None, None, False,
                           1.0, rounds, dropout=half)
    keep = fa.dropout_keep_reference(seed, b, h, s, d, 0.5, device="cuda")
    assert torch.equal(dq[..., 0] != 0, keep[..., 0])
    assert not bool(dq[..., 1:].any())


_F32_BIAS_CASES = [
    (64, (1, 1), 2, 4, 512, 512, False, False, 7),      # unmasked tiles
    (64, (1, 4), 2, 4, 300, 700, True, False, None),
    (128, (2, 1), 2, 4, 257, 513, False, True, None),   # odd sk
    (128, (2, 4), 2, 4, 640, 333, False, False, 100),
    (64, (3, 2), 3, 2, 128, 129, True, True, None),
    (80, (1, 1), 1, 2, 96, 77, False, False, 0),        # padded head dim
]


@pytest.mark.parametrize("d,bdims,b,h,sq,sk,causal,seg,dead",
                         _F32_BIAS_CASES)
@pytest.mark.parametrize("split", [False, True])
def test_flash_f32_bias_matches_plain(gen, d, bdims, b, h, sq, sk, causal,
                                      seg, dead, split):
    """fp32 with a bias on the FFMA route: the forward's bias variant, then
    the single pass's or the split's (forced), against the plain versions
    with the same bias (out 1e-5, lse 1e-5 relative, gradients 1e-4); a
    row -inf everywhere is dead (out, dq exactly 0, lse the fill), row 1
    is -inf but for key 0, which the mask keeps, so its output is v[0]
    bit for bit; every output bitwise on a rerun; the bias counters move
    beside the route's own."""
    f32 = torch.float32
    q, k, v, do, bias, sid_q, sid_kv = _bias_inputs(
        gen, f32, d, bdims, b, h, sq, sk, seg, dead)
    bias[:, :, 1] = float("-inf")
    bias[:, :, 1, 0] = 0.0
    scale = d ** -0.5
    f, g = fa.flash_attention, fa.flash_attention_bwd

    def counts():
        return (f.f32_bias_launches, g.f32_bias_launches,
                g.f32_bias_dkdv_launches, g.f32_bias_dq_launches)

    n0 = counts()
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal, scale,
                                      bias=bias)
    again = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal, scale,
                                   bias=bias)
    grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                               scale, split=split, bias=bias)
    grads2 = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                                scale, split=split, bias=bias)
    torch.cuda.synchronize()
    moved = tuple(a - b_ for a, b_ in zip(counts(), n0))
    assert moved == ((2, 0, 2, 2) if split else (2, 2, 0, 0))
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, grads2))
    assert torch.equal(out[:, :, 1], v[:, :, 0].expand_as(out[:, :, 1]))
    kw = dict(causal=causal, segment_ids_q=sid_q, segment_ids_kv=sid_kv,
              scale=scale, bias=bias)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    _close_fp32(out, ref, 1e-5)
    live = ref_lse > -1e29
    rel = (lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)
    assert float(rel[live].max()) <= 1e-5
    assert torch.equal(lse[~live], ref_lse[~live])
    for got, r in zip(grads, fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, **kw)):
        _close_fp32(got, r)
    if dead is not None:
        assert float(out[:, :, dead].abs().max()) == 0.0
        assert bool((lse[:, :, dead] == -1e30).all())
        assert float(grads[0][:, :, dead].abs().max()) == 0.0


def test_flash_f32_bias_refuses_dropout_before_any_launch(gen):
    """The FFMA route takes the bias with dropout now (its variants with
    both): through ``flash_attention`` (grads or not; s64 stays on the
    single pass) and each split wrapper alone, every launch counted on the
    counters with both alone; frag.cuh (fp32 at kernel head dim 256)
    still refuses the pair before any launch."""
    q = _rand(gen, 1, 2, 64, 64, dtype=torch.float32)
    bias = torch.zeros(1, 1, 64, 64, device="cuda")
    f, g = fa.flash_attention, fa.flash_attention_bwd

    def counts():
        return (f.f32_bias_dropout_launches, g.f32_bias_dropout_launches,
                g.f32_bias_dropout_dkdv_launches,
                g.f32_bias_dropout_dq_launches, f.f32_bias_launches,
                f.f32_dropout_launches, g.f32_bias_launches,
                g.f32_dropout_launches, g.f32_bias_dkdv_launches,
                g.f32_dropout_dkdv_launches, g.f32_bias_dq_launches,
                g.f32_dropout_dq_launches)

    n0 = counts()
    kw = dict(bias=bias, dropout_rate=0.1, dropout_seed=3)
    for grad in (True, False):
        qg = q.clone().requires_grad_(grad)
        out = fa.flash_attention(qg, qg, qg, **kw)
        if grad:
            out.sum().backward()
    lse = torch.zeros(1, 2, 64, device="cuda")
    bop = fa._bias_operand(bias, 1, 2, 64, 64, q.device, 0.125)
    for wrapper in (fa._flash_dkdv_cuda, fa._flash_dq_cuda):
        wrapper(q, q, q, q, lse, lse, None, None, False, 0.125,
                fa._NO_ROUNDS, dropout=fa._dropout_args(0.1, 3), bias=bop)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), n0)) == (
        2, 1, 1, 1) + (0,) * 8
    q256 = _rand(gen, 1, 2, 64, 256, dtype=torch.float32)
    n1 = (f.launches, g.launches, g.dkdv_launches, g.dq_launches)
    for grad in (True, False):
        qg = q256.clone().requires_grad_(grad)
        with pytest.raises(NotImplementedError, match="bias.*frag.cuh"):
            fa.flash_attention(qg, qg, qg, **kw)
    assert (f.launches, g.launches, g.dkdv_launches, g.dq_launches) == n1


# ---------------------------------------------------------------------------
# the fp32 FFMA route with the bias and dropout together (B1-B4's variants
# with both), and the wgmma bias variants on rows at the -1e30 fill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,bdims,b,h,sq,sk,causal,seg,dead",
                         _F32_BIAS_CASES)
@pytest.mark.parametrize("split", [False, True])
def test_flash_f32_bias_dropout_matches_plain(gen, d, bdims, b, h, sq, sk,
                                              causal, seg, dead, split):
    """fp32 with a bias and dropout 0.1 on the FFMA route: the forward's
    variant with both, then the single pass's or the split's (forced),
    against the plain versions with the same bias and seed (out 1e-5, lse
    1e-5 relative, gradients 1e-4); a row -inf everywhere is dead (out and
    dq exactly 0, lse the fill, whatever its keep bits), row 1 is -inf but
    for key 0, so its output is v[0] / (1 - rate) where key 0 is kept and
    0 where it is dropped, bit for bit; every output bitwise on a rerun;
    only the counters with both move beside the route's own."""
    f32, rate, seed = torch.float32, 0.1, 1234
    q, k, v, do, bias, sid_q, sid_kv = _bias_inputs(
        gen, f32, d, bdims, b, h, sq, sk, seg, dead)
    bias[:, :, 1] = float("-inf")
    bias[:, :, 1, 0] = 0.0
    scale = d ** -0.5
    drop = dict(dropout_rate=rate, dropout_seed=seed)
    f, g = fa.flash_attention, fa.flash_attention_bwd

    def counts():
        return (f.f32_bias_dropout_launches, g.f32_bias_dropout_launches,
                g.f32_bias_dropout_dkdv_launches,
                g.f32_bias_dropout_dq_launches, f.f32_bias_launches,
                f.f32_dropout_launches, g.f32_bias_launches,
                g.f32_dropout_launches)

    n0 = counts()
    out, lse = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal, scale,
                                      bias=bias, **drop)
    again = fa.flash_attention_fwd(q, k, v, sid_q, sid_kv, causal, scale,
                                   bias=bias, **drop)
    grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                               scale, split=split, bias=bias, **drop)
    grads2 = fa._flash_bwd_cuda(q, k, v, out, lse, do, sid_q, sid_kv, causal,
                                scale, split=split, bias=bias, **drop)
    torch.cuda.synchronize()
    moved = tuple(a - b_ for a, b_ in zip(counts(), n0))
    assert moved == ((2, 0, 2, 2) if split else (2, 2, 0, 0)) + (0,) * 4
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, grads2))
    keep = fa.dropout_keep_reference(seed, b, h, sq, sk, rate, device="cuda")
    inv = torch.tensor(1.0 / (1.0 - rate), dtype=f32, device="cuda")
    one = torch.where(keep[:, :, 1, :1], v[:, :, 0] * inv,
                      torch.zeros_like(v[:, :, 0]))
    assert torch.equal(out[:, :, 1], one)
    kw = dict(causal=causal, segment_ids_q=sid_q, segment_ids_kv=sid_kv,
              scale=scale, bias=bias, **drop)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    _close_fp32(out, ref, 1e-5)
    live = ref_lse > -1e29
    rel = (lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)
    assert float(rel[live].max()) <= 1e-5
    assert torch.equal(lse[~live], ref_lse[~live])
    for got, r in zip(grads, fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, **kw)):
        _close_fp32(got, r)
    if dead is not None:
        assert float(out[:, :, dead].abs().max()) == 0.0
        assert bool((lse[:, :, dead] == -1e30).all())
        assert float(grads[0][:, :, dead].abs().max()) == 0.0


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("split", [False, True])
def test_flash_f32_bias_dropout_keep_pattern_is_the_plain_mask(gen, d,
                                                               split):
    """Rate 0.5 under a finite bias (0.5 randn, [1, h, s, s]), no mask. The
    forward with q = k = 0 and v = I over sk = d keys: out[q, k] = 2 p[q,
    k] where the key is kept, exactly 0 where it is dropped. The backward
    (the single pass or the split) with q = 0 and do = I over sq = d rows:
    dv = the dropped p transposed. The split's dq with key 0 = e_0 and the
    others 0, v = I, do = 1 and delta 0: dq[q] = ds[q, 0] e_0, nonzero
    exactly where key 0 is kept. Every zero pattern is the plain mask bit
    for bit."""
    f32, b, h, s, seed = torch.float32, 2, 3, 333, -21
    half = dict(dropout_rate=0.5, dropout_seed=seed)
    eye = torch.eye(d, device="cuda").expand(b, h, d, d).contiguous()
    bias_fwd = 0.5 * _rand(gen, 1, h, s, d, dtype=f32)
    q = torch.zeros(b, h, s, d, device="cuda")
    k = torch.zeros(b, h, d, d, device="cuda")
    out, _ = fa.flash_attention_fwd(q, k, eye, None, None, False, 1.0,
                                    bias=bias_fwd, **half)
    keep = fa.dropout_keep_reference(seed, b, h, s, d, 0.5, device="cuda")
    assert torch.equal(out != 0, keep)
    bias_bwd = 0.5 * _rand(gen, 1, h, d, s, dtype=f32)
    k, v = (_rand(gen, b, h, s, d, dtype=f32) for _ in range(2))
    q = torch.zeros(b, h, d, d, device="cuda")
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, False, 1.0,
                                      bias=bias_bwd, **half)
    _, _, dv = fa._flash_bwd_cuda(q, k, v, out, lse, eye, None, None, False,
                                  1.0, split=split, bias=bias_bwd, **half)
    keep = fa.dropout_keep_reference(seed, b, h, d, s, 0.5, device="cuda")
    assert torch.equal(dv != 0, keep.transpose(-1, -2))
    if not split:
        return
    q = _rand(gen, b, h, s, d, dtype=f32)
    kk = torch.zeros(b, h, d, d, device="cuda")
    kk[:, :, 0, 0] = 1.0
    ones = torch.ones(b, h, s, d, device="cuda")
    _, lse = fa.flash_attention_fwd(q, kk, eye, None, None, False, 1.0,
                                    bias=bias_fwd)
    delta = torch.zeros(b, h, s, device="cuda")
    bop = fa._bias_operand(bias_fwd, b, h, s, d, q.device, 1.0)
    dq = fa._flash_dq_cuda(q, kk, eye, ones, lse, delta, None, None, False,
                           1.0, fa._NO_ROUNDS,
                           dropout=fa._dropout_args(0.5, seed), bias=bop)
    keep = fa.dropout_keep_reference(seed, b, h, s, d, 0.5, device="cuda")
    assert torch.equal(dq[..., 0] != 0, keep[..., 0])
    assert not bool(dq[..., 1:].any())


# rows of the fill case: biases at the -1e30 fill and just above it on every
# key (the causal mask keeps a prefix of them), and a row -inf everywhere
_FILL_ROWS = {3: -1e30, 5: -1e30, 7: -8e29, 9: -8e29}
_DEAD_ROW = 11


@pytest.mark.parametrize("dtype", [_BF, _F16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_bias_fill_rows_match_plain(gen, dtype, d, split, rate):
    """The wgmma bias variants (B1, then B2 or the split's B4 and B3; with
    dropout, the variants with both) on rows whose bias is -1e30 or -8e29
    on every key the causal mask keeps, beside a row -inf everywhere:
    against the plain forward and backward end to end (the plain backward
    from the plain lse). Such a row is live: its out is the mean of v over
    the kept keys (the dropped mean with dropout), its lse the fill
    (relative 1e-3), and the backward takes p = 1 on each kept key, as
    the Pallas kernels do; every gradient finite and within the bias
    variants' limits. The -inf row stays dead: out and dq exactly 0, lse
    the fill."""
    b, h, s = 2, 2, 256
    q, k, v, do = (_rand(gen, b, h, s, d, dtype=dtype) for _ in range(4))
    bias = _rand(gen, 1, h, s, s, dtype=torch.float32)
    for row, fill in _FILL_ROWS.items():
        bias[:, :, row] = fill
    bias[:, :, _DEAD_ROW] = float("-inf")
    scale = d ** -0.5
    kw = dict(causal=True, scale=scale, bias=bias)
    if rate:
        kw.update(dropout_rate=rate, dropout_seed=77)
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, True, scale,
                                      bias=bias, dropout_rate=rate,
                                      dropout_seed=77 if rate else None)
    grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, True,
                               scale, split=split, bias=bias,
                               dropout_rate=rate,
                               dropout_seed=77 if rate else None)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    rows = list(_FILL_ROWS)
    mean = v.float().cumsum(2)[:, :, rows] / torch.tensor(
        [r + 1.0 for r in rows], device="cuda")[:, None]
    if not rate:    # the plain version is the kept mean there
        _close(ref[:, :, rows], mean, 1e-3)
    _close(out, ref, 4e-3)
    rel = (lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)
    assert float(rel.max()) <= 1e-3
    assert bool((lse[:, :, rows] < -6e29).all())
    rgrads = fa.flash_attention_bwd_reference(q, k, v, ref, ref_lse, do,
                                              **kw)
    for name, got, r in zip(("dq", "dk", "dv"), grads, rgrads):
        assert bool(torch.isfinite(got.float()).all()), name
        _close_grad(got, r, name)
    assert float(grads[0][:, :, rows].float().abs().max()) > 0.0
    assert float(out[:, :, _DEAD_ROW].float().abs().max()) == 0.0
    assert bool((lse[:, :, _DEAD_ROW] == -1e30).all())
    assert float(grads[0][:, :, _DEAD_ROW].float().abs().max()) == 0.0
