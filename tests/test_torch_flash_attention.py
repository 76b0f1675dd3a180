"""apex_tpu_torch flash attention (forward and backward) and paged decode
attention against the JAX package.

Inputs are made with numpy from a seed and handed to both sides. The JAX
kernels run in Pallas interpret mode, as the JAX package's own CPU tests
run them; the port's wrappers run their plain versions on CPU tensors.
Tolerances: fp32 within 1e-5 absolute (fp32 math on both sides, other
summation order); bf16 within 2e-2 absolute (the Pallas kernel rounds p to
bf16 before its PV product, the plain version does not; outputs are bf16).
"""

import importlib

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# ``apex_tpu.ops`` re-exports a function of the same name as the module
jfa = importlib.import_module("apex_tpu.ops.flash_attention")
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import flash_attention as tfa

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _segments(b, s):
    """Row 0: one segment, padding (-1) from 29; row 1: two packed
    segments, then padding."""
    sid = np.zeros((b, s), np.int32)
    sid[0, 29:] = -1
    sid[1, 20:32] = 1
    sid[1, 32:] = -1
    return sid


def _pair(a, dtype):
    """The same numbers as a JAX array and a torch tensor in ``dtype``."""
    if dtype == "bfloat16":
        return (jnp.asarray(a.astype(ml_dtypes.bfloat16)),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_matches_jax_interpret(dtype):
    rng = np.random.RandomState(0)
    b, h, s, d = 2, 2, 40, 16
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    sid = _segments(b, s)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    scale = d ** -0.5
    ref = jfa.flash_attention(jq, jk, jv, segment_ids_q=jnp.asarray(sid),
                              causal=True, scale=scale, block_q=16,
                              block_k=16, block_q_bwd=16, block_k_bwd=16,
                              interpret=True, autotune="off")
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(tq, tk, tv, segment_ids_q=torch.from_numpy(sid),
                              causal=True, scale=scale)
    assert tfa.flash_attention.launches == before     # CPU: no kernel
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(ref), atol=TOL[dtype], rtol=0)
    # padding rows are exactly zero
    assert float(got[0, :, 29:].abs().max()) == 0.0
    assert float(got[1, :, 32:].abs().max()) == 0.0


def test_flash_lse_matches_jax_forward_impl():
    rng = np.random.RandomState(1)
    b, h, s, d = 2, 2, 40, 16
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    sid = _segments(b, s)
    scale = d ** -0.5
    _, jlse = jfa._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sid),
        None, None, jnp.zeros((1,), jnp.int32), scale, True, 0.0, 16, 16,
        True)
    _, tlse = tfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(sid), None, True, scale)
    jlse = np.asarray(jlse).reshape(b, h, -1)[:, :, :s]
    live = np.broadcast_to((sid >= 0)[:, None, :], (b, h, s))
    np.testing.assert_allclose(tlse.numpy()[live], jlse[live], atol=1e-5)
    # rows that see no key: -1e30 on both sides
    assert np.all(tlse.numpy()[:, :, 32:] == np.float32(-1e30))
    assert np.all(jlse[:, :, 32:] == np.float32(-1e30))


@pytest.mark.parametrize("case", ["bias", "causal_sq_lt_sk"])
def test_mha_reference_matches_jax(case):
    rng = np.random.RandomState(2)
    b, h, sq, sk, d = 2, 3, 12, 20, 8
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k, v = (rng.randn(b, h, sk, d).astype(np.float32) for _ in range(2))
    kw_j, kw_t = {}, {}
    if case == "bias":
        bias = rng.randn(1, h, sq, sk).astype(np.float32)
        kw_j["bias"], kw_t["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    else:
        kw_j["causal"] = kw_t["causal"] = True
    ref = jfa.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw_j)
    got = tfa.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_matches_jax_interpret(dtype):
    """GQA group 3, an inactive slot (seq_len 0) and a partly dead page."""
    rng = np.random.RandomState(3)
    b, kv, g, d = 3, 2, 3, 16
    page, n_pages, m = 8, 9, 4
    q = (rng.randn(b, kv, g, d) * 0.3).astype(np.float32)
    kp = (rng.randn(kv, n_pages, page, d) * 0.3).astype(np.float32)
    vp = (rng.randn(kv, n_pages, page, d) * 0.3).astype(np.float32)
    bt = rng.randint(1, n_pages, (b, m)).astype(np.int32)
    sl = np.asarray([13, 0, 32], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kp, vp))
    ref = jfa.paged_decode_attention(jq, jk, jv, jnp.asarray(bt),
                                     jnp.asarray(sl), interpret=True)
    jref = jfa.paged_attention_reference(jq, jk, jv, jnp.asarray(bt),
                                         jnp.asarray(sl))
    before = tfa.paged_decode_attention.launches
    got = tfa.paged_decode_attention(tq, tk, tv, torch.from_numpy(bt),
                                     torch.from_numpy(sl))
    assert tfa.paged_decode_attention.launches == before
    assert got.dtype == tq.dtype and tuple(got.shape) == (b, kv, g, d)
    np.testing.assert_allclose(_np(got), _np(ref), atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(_np(got), _np(jref), atol=TOL[dtype], rtol=0)
    assert float(got[1].abs().max()) == 0.0          # inactive: exact zeros


def test_wrappers_reject_unported_and_foreign_inputs():
    q = torch.zeros(1, 2, 8, 16)
    # dropout runs on the CPU (its plain version); a rate without a seed
    # is refused as the JAX package refuses it
    with pytest.raises(ValueError, match="requires dropout_seed"):
        tfa.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match="not supported"):
        tfa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    qp = torch.zeros(2, 2, 1, 16)
    pages = torch.zeros(2, 4, 8, 16)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    sl = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not match"):
        tfa.paged_decode_attention(qp, torch.zeros(3, 4, 8, 16), pages, bt,
                                   sl)
    with pytest.raises(ValueError, match="BOTH"):
        tfa.paged_decode_attention(qp, pages, pages, bt, sl,
                                   k_scales=torch.ones(2, 4))
    with pytest.raises(ValueError, match="not supported"):
        tfa.paged_decode_attention(qp.to("meta"), pages.to("meta"),
                                   pages.to("meta"), bt.to("meta"),
                                   sl.to("meta"))


# ---------------------------------------------------------------------------
# the build of the CUDA sources (a stand-in nvcc: the real one runs on the
# machine with the card)
# ---------------------------------------------------------------------------

def _fake_cuda_home(tmp_path, body):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return str(tmp_path / "cuda")


def test_build_all_compiles_each_source_for_sm90a(tmp_path, monkeypatch):
    # the stand-in records its arguments and writes the -o target
    body = ('echo "$@" > "$(dirname "$0")/args.$$"\n'
            'while [ "$1" != "-o" ]; do shift; done\n'
            'echo lib > "$2"\necho "ptxas info : Used 1 registers"\n')
    monkeypatch.setenv("CUDA_HOME", _fake_cuda_home(tmp_path, body))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    names = ["flash_fwd", "paged_decode"]
    _build.build_all(names)
    for name in names:
        lib = _build.library_path(name)
        assert lib.parent == tmp_path / "build" and lib.is_file()
        assert "registers" in lib.with_suffix(".log").read_text()
    calls = sorted(p.read_text() for p in (tmp_path / "cuda" / "bin").glob(
        "args.*"))
    assert len(calls) == 2
    for call in calls:
        assert "-gencode arch=compute_90a,code=sm_90a" in call
        assert "-shared" in call and "-O3" in call
    # a built library is reused, not rebuilt
    _build.build_all(names)
    assert len(list((tmp_path / "cuda" / "bin").glob("args.*"))) == 2


def test_build_failure_raises_with_the_compiler_log(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", _fake_cuda_home(
        tmp_path, 'echo "error: bad kernel"\nexit 3\n'))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build_all(["flash_fwd"])
    assert not _build.library_path("flash_fwd").exists()
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        _build.check(700, "launch")


# ---------------------------------------------------------------------------
# the backward: the port's plain backward (``flash_attention_bwd_reference``,
# reached through autograd on CPU tensors) against the JAX package's
# ``_bwd_math`` and its Pallas backward in interpret mode. fp32 within 1e-5
# of the largest gradient; bf16 within two bf16 ulps plus 2 % of the
# largest: the Pallas kernel rounds p and ds to bf16 before its products,
# the plain version (like ``_bwd_math``) keeps them fp32.
# ---------------------------------------------------------------------------

def _close_grad(got, ref, dtype):
    got, ref = _np(got), _np(ref)
    scale = float(np.abs(ref).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=0)
    else:
        tol = np.abs(ref) * 2 * 2.0 ** -7 + 2e-2 * scale
        assert np.all(np.abs(got - ref) <= tol), float(np.abs(got - ref).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_matches_jax(dtype, causal):
    rng = np.random.RandomState(4)
    b, h, s, d = 2, 2, 40, 16
    q, k, v, do = (rng.randn(b, h, s, d).astype(np.float32)
                   for _ in range(4))
    sid = _segments(b, s)                 # padding rows and two segments
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (_pair(a, dtype)
                                                for a in (q, k, v, do))
    scale = d ** -0.5

    def jf(qq, kk, vv):
        return jfa.flash_attention(qq, kk, vv, segment_ids_q=jnp.asarray(sid),
                                   causal=causal, scale=scale, block_q=16,
                                   block_k=16, block_q_bwd=16,
                                   block_k_bwd=16, interpret=True,
                                   autotune="off")

    jout, vjp = jax.vjp(jf, jq, jk, jv)
    jgrads = vjp(jdo)
    _, jlse = jfa._flash_fwd_impl(jq, jk, jv, jnp.asarray(sid), None, None,
                                  jnp.zeros((1,), jnp.int32), scale, causal,
                                  0.0, 16, 16, True)
    jlse = jnp.asarray(jlse).reshape(b, h, -1)[:, :, :s]
    math_grads = jfa._bwd_math(
        (jq, jk, jv, jout, jlse, jnp.asarray(sid), None, None, None), jdo,
        scale=scale, causal=causal)
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    before = tfa.flash_attention_bwd.launches
    out = tfa.flash_attention(tq, tk, tv, segment_ids_q=torch.from_numpy(sid),
                              causal=causal, scale=scale)
    out.backward(tdo)
    assert tfa.flash_attention_bwd.launches == before   # CPU: no kernel
    for got, ref, ref_math in zip((tq.grad, tk.grad, tv.grad), jgrads,
                                  math_grads):
        assert got.dtype == tq.dtype
        _close_grad(got, ref, dtype)
        _close_grad(got, ref_math, dtype)
    # padding query rows get exactly zero dq
    assert float(tq.grad[0, :, 29:].abs().max()) == 0.0
    assert float(tq.grad[1, :, 32:].abs().max()) == 0.0


def test_flash_bwd_reference_matches_jax_bwd_math_sq_ne_sk():
    """End-aligned causal with sq < sk, fp32, straight through the plain
    backward against ``_bwd_math`` on the same residuals."""
    rng = np.random.RandomState(5)
    b, h, sq, sk, d = 1, 2, 12, 20, 8
    q, do = (rng.randn(b, h, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, sk, d).astype(np.float32) for _ in range(2))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = tfa.flash_attention_fwd(tq, tk, tv, causal=True)
    got = tfa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal=True)
    ref = jfa._bwd_math((jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(out.numpy()), jnp.asarray(lse.numpy()),
                         None, None, None, None), jnp.asarray(do),
                        scale=d ** -0.5, causal=True)
    for g, r in zip(got, ref):
        _close_grad(g, r, "float32")


# ---------------------------------------------------------------------------
# the two-kernel split past the JAX package's 2 MB gate: the port routes the
# same shapes as JAX (the gate helper against the kernels JAX's backward
# traces), and its plain backward — the same function on either route —
# matches JAX's split Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def _jax_backward_kernels(s, d, causal):
    """How many Pallas kernels the JAX backward launches at [1, 1, s, d]
    bf16 with its default blocks: 1 (single pass) or 2 (the split)."""
    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=causal,
                                           interpret=True, autotune="off")
                       .astype(jnp.float32))

    aval = jax.ShapeDtypeStruct((1, 1, s, d), jnp.bfloat16)
    fwd = str(jax.make_jaxpr(loss)(aval, aval, aval)).count("pallas_call")
    both = str(jax.make_jaxpr(jax.grad(loss, argnums=(0, 1, 2)))(
        aval, aval, aval)).count("pallas_call")
    return both - fwd


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,kv_bytes,split", [
    (1024, None, False), (2048, 1_572_864, False), (2049, 2_359_296, True),
    (4096, 3_145_728, True)])
def test_split_gate_routes_as_jax(s, kv_bytes, split, causal):
    d = 64
    got = tfa.backward_kv_bytes(s, s, d, 2, 2, causal)
    if kv_bytes is not None:
        assert got == kv_bytes
    assert tfa.uses_split_backward(s, s, d, 2, 2, causal) is split
    assert _jax_backward_kernels(s, d, causal) == (2 if split else 1)


def test_split_gate_counts_bias_and_dropout_as_jax():
    # bias and dropout each add a [block_q, block_k] fp32 block, and both
    # together take 512 blocks: d64 s1536 counts 1.57 MB alone (sk padded
    # to 2048 by 1024 blocks), 1.18 MB + 2 x 1 MB with both
    assert tfa.backward_kv_bytes(1536, 1536, 64) == 2048 * 64 * 12
    assert not tfa.uses_split_backward(1536, 1536, 64)
    assert tfa.backward_kv_bytes(1536, 1536, 64, bias=True, dropout=True) \
        == 1536 * 64 * 12 + 2 * 4 * 512 * 512
    assert tfa.uses_split_backward(1536, 1536, 64, bias=True, dropout=True)
    assert tfa._FUSED_BWD_MAX_KV_BYTES == jfa._FUSED_BWD_MAX_KV_BYTES


@pytest.mark.parametrize("features", ["causal", "segments"])
def test_plain_backward_matches_jax_two_kernel_split(features, monkeypatch):
    """JAX forced onto its split (``_FUSED_BWD_MAX_KV_BYTES`` = 0, as
    tests/test_flash_attention.py forces it), in interpret mode at s256
    d32, fp32: within 1e-5 of the largest gradient."""
    rng = np.random.RandomState(11)
    b, h, s, d = 1, 2, 256, 32
    q, k, v, do = (rng.randn(b, h, s, d).astype(np.float32)
                   for _ in range(4))
    kw = dict(causal=True)
    tkw = dict(causal=True)
    if features == "segments":
        sid = (rng.randint(0, 3, (b, s)).cumsum(-1) // 2).astype(np.int32)
        sid[:, -20:] = -1                                   # padding rows
        kw.update(segment_ids_q=jnp.asarray(sid))
        tkw.update(segment_ids_q=torch.from_numpy(sid))
    monkeypatch.setattr(jfa, "_FUSED_BWD_MAX_KV_BYTES", 0)

    def jf(qq, kk, vv):
        return jfa.flash_attention(qq, kk, vv, block_q=128, block_k=128,
                                   block_q_bwd=128, block_k_bwd=128,
                                   interpret=True, autotune="off", **kw)

    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tfa.flash_attention(tq, tk, tv, **tkw).backward(torch.from_numpy(do))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close_grad(got, ref, "float32")


# ---------------------------------------------------------------------------
# the shapes and dtypes the kernels used to refuse (ROADMAP §C faults 1-4):
# head dims past 256, the fp32 backward past 128, paged decode at any head
# dim, and operands of mixed dtypes. The port's plain versions against the
# JAX package in interpret mode; on the card the kernels are held against
# the plain versions (tests/test_torch_cuda_kernels.py).
# ---------------------------------------------------------------------------

def _arr(a, dtype):
    """The same numbers as a JAX array and a torch tensor in ``dtype``
    (a numpy dtype name)."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _flash_both(dtypes, d, s=40, seed=6):
    rng = np.random.RandomState(seed)
    b, h = 1, 2
    arrays = [0.5 * rng.randn(b, h, s, d).astype(np.float32)
              for _ in range(4)]
    pairs = [_arr(a, dt) for a, dt in zip(arrays, dtypes)]
    scale = d ** -0.5

    def jf(qq, kk, vv):
        return jfa.flash_attention(qq, kk, vv, causal=True, scale=scale,
                                   block_q=16, block_k=16, block_q_bwd=16,
                                   block_k_bwd=16, interpret=True,
                                   autotune="off")

    jout, vjp = jax.vjp(jf, *(p[0] for p in pairs[:3]))
    jgrads = vjp(pairs[3][0])
    tq, tk, tv = (p[1].requires_grad_() for p in pairs[:3])
    out = tfa.flash_attention(tq, tk, tv, causal=True, scale=scale)
    out.backward(pairs[3][1])
    return out, jout, (tq.grad, tk.grad, tv.grad), jgrads


@pytest.mark.parametrize("dtype,d", [("bfloat16", 320), ("bfloat16", 512),
                                     ("float32", 256), ("float32", 512)])
def test_flash_large_head_dims_match_jax_interpret(dtype, d):
    """d 320 (run at 512 on the card), 512, and fp32 past d 128: forward
    and backward."""
    out, jout, grads, jgrads = _flash_both((dtype,) * 4, d)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(out.detach()), _np(jout),
                               atol=TOL[dtype], rtol=0)
    for got, ref in zip(grads, jgrads):
        assert got.dtype == getattr(torch, dtype)
        _close_grad(got, ref, dtype)


@pytest.mark.parametrize("dtypes", [
    ("float32", "bfloat16", "bfloat16", "float32"),
    ("bfloat16", "float32", "float32", "bfloat16"),
    ("bfloat16", "bfloat16", "float16", "bfloat16")])
def test_flash_mixed_dtypes_match_jax_interpret(dtypes):
    """The mixes the JAX kernels take (q, k, v, and dout in q's dtype): the
    output in q's dtype, each gradient in its input's. The JAX kernels
    round p to v's dtype (and in the backward to dout's, ds to q's and
    k's) where the plain versions keep fp32, so both are held at the bf16
    limits whenever a 16-bit operand is in the mix."""
    out, jout, grads, jgrads = _flash_both(dtypes, 48)
    assert out.dtype == getattr(torch, dtypes[0])
    assert str(jout.dtype) == dtypes[0]
    np.testing.assert_allclose(_np(out.detach()), _np(jout),
                               atol=TOL["bfloat16"], rtol=0)
    for got, ref, dt in zip(grads, jgrads, dtypes):
        assert got.dtype == getattr(torch, dt) and str(ref.dtype) == dt
        _close_grad(got, ref, "bfloat16")


def test_mixed_dtype_promotion_and_roundings():
    """The kernels run a mix in its promoted dtype (exact) and round where
    the JAX kernels cast to an operand's dtype: codes 0 bf16, 1 fp16,
    2 none, two bits each for p (dout's), ds before dk (q's) and before dq
    (k's)."""
    bf, f16, f32 = (torch.zeros(1, dtype=t) for t in
                    (torch.bfloat16, torch.float16, torch.float32))
    same, dt = tfa._promoted(bf, bf, bf)
    assert dt == torch.bfloat16 and all(a is b for a, b in zip(same,
                                                              (bf, bf, bf)))
    assert tfa._promoted(bf, bf, f16)[1] == torch.float32
    mixed, dt = tfa._promoted(f32, bf, bf)
    assert dt == torch.float32 and all(t.dtype == dt for t in mixed)
    assert tfa._mixed_rounds(f32, bf, f32) == 2 | 2 << 2 | 0 << 4
    assert tfa._mixed_rounds(bf, f32, bf) == 0 | 0 << 2 | 2 << 4
    assert tfa._mixed_rounds(f32, f32, f32) == 0x2A


def _paged_pool(rng, kv, n_pages, page, d, mode):
    """A pool in `mode` ('bfloat16', 'float32' or 'e4m3', one scale per
    (kv head, page)) as (jax k, torch k, jax v, torch v, scales)."""
    kp = (rng.randn(kv, n_pages, page, d) * 0.3).astype(np.float32)
    vp = (rng.randn(kv, n_pages, page, d) * 0.3).astype(np.float32)
    if mode != "e4m3":
        (jk, tk), (jv, tv) = _arr(kp, mode), _arr(vp, mode)
        return jk, tk, jv, tv, None
    sc = (rng.rand(kv, n_pages) + 0.5).astype(np.float32)
    out = []
    for a in (kp, vp):
        q8 = (a * sc[:, :, None, None]).astype(ml_dtypes.float8_e4m3fn)
        out += [jnp.asarray(q8),
                torch.from_numpy(q8.view(np.uint8)).view(torch.float8_e4m3fn)]
    return (*out, sc)


@pytest.mark.parametrize("d,q_dtype,pool", [
    (80, "bfloat16", "bfloat16"), (80, "bfloat16", "e4m3"),
    (96, "bfloat16", "bfloat16"), (96, "float32", "e4m3"),
    (256, "bfloat16", "bfloat16"), (256, "bfloat16", "e4m3"),
    (64, "float32", "bfloat16"), (64, "bfloat16", "float32")])
def test_paged_decode_head_dims_and_mixed_dtypes_match_jax(d, q_dtype, pool):
    """Head dims 80, 96 and 256 in both pool modes, and queries over a pool
    of another dtype. Held within the output dtype's limit of the JAX
    kernel in interpret mode (which rounds p to a 16-bit pool's dtype) and
    of the JAX plain version (fp32 math on both sides: 1e-5 for fp32
    queries)."""
    rng = np.random.RandomState(d)
    b, kv, g, page, n_pages, m = 3, 2, 3, 8, 9, 4
    jq, tq = _arr((rng.randn(b, kv, g, d) * 0.3).astype(np.float32), q_dtype)
    jk, tk, jv, tv, sc = _paged_pool(rng, kv, n_pages, page, d, pool)
    bt = rng.randint(1, n_pages, (b, m)).astype(np.int32)
    sl = np.asarray([13, 0, 32], np.int32)
    jkw, tkw = {}, {}
    if sc is not None:
        jkw = dict(k_scales=jnp.asarray(sc), v_scales=jnp.asarray(sc))
        tkw = dict(k_scales=torch.from_numpy(sc),
                   v_scales=torch.from_numpy(sc))
    ref = jfa.paged_decode_attention(jq, jk, jv, jnp.asarray(bt),
                                     jnp.asarray(sl), interpret=True, **jkw)
    jref = jfa.paged_attention_reference(jq, jk, jv, jnp.asarray(bt),
                                         jnp.asarray(sl), **jkw)
    got = tfa.paged_decode_attention(tq, tk, tv, torch.from_numpy(bt),
                                     torch.from_numpy(sl), **tkw)
    assert got.dtype == tq.dtype and tuple(got.shape) == (b, kv, g, d)
    tol = TOL["float32"] if q_dtype == "float32" else TOL["bfloat16"]
    np.testing.assert_allclose(_np(got), _np(jref), atol=tol, rtol=0)
    kernel_tol = tol if pool in ("float32", "e4m3") else TOL["bfloat16"]
    np.testing.assert_allclose(_np(got), _np(ref), atol=kernel_tol, rtol=0)
    assert float(got[1].abs().max()) == 0.0          # inactive: exact zeros
