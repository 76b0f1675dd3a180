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
apart can flip one rounding), held like the flash gradients.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.amp import fp8
from apex_tpu_torch.ops import flash_attention as fa
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
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_fwd(q.float(), q.float(), q.float())
    qt = _rand(gen, 1, 16, 2, 64).transpose(1, 2)      # [1, 2, 16, 64]
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(qt, qt, qt)
    with pytest.raises(ValueError, match="head dim"):
        qq = _rand(gen, 1, 2, 16, 48)
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
    with pytest.raises(ValueError, match="multiples of 16"):
        mm.fp8_dequant_matmul(_rand(gen, 8, 40), w8[:40], one)
    with pytest.raises(ValueError, match="one fp32 value"):
        mm.fp8_dequant_matmul(_rand(gen, 8, 64), w8, one.double())
    with pytest.raises(ValueError, match="int32"):
        fa.paged_decode_attention(qp, pages, pages, bt.long(), sl)
    with pytest.raises(ValueError, match="group"):
        fa.paged_decode_attention(_rand(gen, 2, 2, 9, 64), pages, pages,
                                  bt, sl)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        ln.fused_layer_norm_affine(q, torch.ones(64, device="cuda").double(),
                                   torch.zeros(64, device="cuda"), (64,),
                                   out_dtype=torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, q, q, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd(q, q, q, o, lse, qt, causal=True)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_bwd(q.float(), q.float(), q.float(), o.float(),
                               lse, o.float())
    x = _rand(gen, 8, 256)
    e = _rand(gen, 100, 256)
    t = torch.zeros(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        ce.lm_head_ce_fwd(x.float(), e.float(), t)
    with pytest.raises(ValueError, match="int32"):
        ce.lm_head_ce_fwd(x, e, t.long())
    with pytest.raises(ValueError, match="contiguous"):
        ce.lm_head_ce_fwd(_rand(gen, 256, 8).t(), e, t)
    m = torch.zeros(8, device="cuda")
    with pytest.raises(ValueError, match="hidden size"):
        ce.lm_head_ce_bwd(_rand(gen, 8, 320), _rand(gen, 100, 320), t, m,
                          m + 1, m)
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
