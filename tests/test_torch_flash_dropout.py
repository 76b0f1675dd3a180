"""Attention dropout in apex_tpu_torch's flash attention against the JAX
package, on the CPU.

The keep mask is a pure hash of (seed, batch, head, q position, k position)
(``_fmix32``/``_keep_from_positions``, apex_tpu/ops/flash_attention.py
:140-182); the port computes it in int64 with 32-bit wrapping and must
match JAX's uint32 arithmetic bit for bit, and so must the CUDA kernels'
header (``csrc/dropout_hash.cuh``, compiled here by the host compiler).
The plain forward, its lse and the q/k/v gradients are held against
``apex_tpu.ops.flash_attention.flash_attention`` in Pallas interpret mode
(as the JAX package's own CPU tests run it) with the same seed: fp32 on
both sides, so within 1e-5 (forward, lse) and 1e-4 of the largest gradient
(summation order). The CUDA routes that do not take dropout yet are
checked through their route predicate and the wrappers' refusals before
any launch, and the split's wgmma route through its C calls' arguments
(the library stubbed): no card is needed.
"""

import ctypes
import importlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# ``apex_tpu.ops`` re-exports a function of the same name as the module
jfa = importlib.import_module("apex_tpu.ops.flash_attention")
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import flash_attention as tfa

SEEDS = [0, 1, -5, 2 ** 31 - 1, -2 ** 31, 987654321]
RATES = [0.1, 0.5, 0.9]


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seed", SEEDS)
def test_keep_mask_is_bitwise_jax(seed, rate):
    b, h, sq, sk = 2, 3, 37, 53
    want = np.asarray(jfa.dropout_keep_reference(jnp.int32(seed), b, h, sq,
                                                 sk, rate))
    got = tfa.dropout_keep_reference(seed, b, h, sq, sk, rate, device="cpu")
    assert got.dtype == torch.bool and tuple(got.shape) == (b, h, sq, sk)
    np.testing.assert_array_equal(got.numpy(), want)


def test_threshold_is_computed_as_jax_computes_it():
    for rate in (0.0, 1e-12, 0.1, 0.5, 0.9, 1.0 - 2.0 ** -40):
        assert tfa.dropout_threshold(rate) == min(
            int(rate * 4294967296.0), 4294967295)
    assert tfa.dropout_threshold(0.5) == 2 ** 31
    assert tfa.dropout_threshold(1.0 - 2.0 ** -40) == 2 ** 32 - 1
    # the kernels' arguments: the seed wraps to uint32, threshold 0 is no
    # dropout
    assert tfa._dropout_args(0.5, -1) == (2 ** 32 - 1, 2 ** 31, 2.0)
    assert tfa._dropout_args(0.0, None) == (0, 0, 1.0)


_HOST_MASK = r"""
#include "dropout_hash.cuh"
extern "C" void keep_mask(unsigned seed, unsigned threshold, int b, int h,
                          int sq, int sk, unsigned char* keep) {
  long at = 0;
  for (int bi = 0; bi < b; ++bi)
    for (int hi = 0; hi < h; ++hi) {
      const unsigned bs = dropout::base(seed, bi, hi);
      for (int q = 0; q < sq; ++q)
        for (int k = 0; k < sk; ++k)
          keep[at++] = dropout::keep(
              bs ^ dropout::q_term(q) ^ dropout::k_term(k), threshold);
    }
}
"""


def test_kernel_hash_header_is_bitwise_the_plain_mask(tmp_path):
    """``csrc/dropout_hash.cuh``, which both wgmma kernels include, built
    by the host compiler: the same mask as the plain version (and so as
    JAX) over seeds and rates."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = tmp_path / "mask.cpp"
    src.write_text(_HOST_MASK)
    lib = tmp_path / "libmask.so"
    subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-I", str(_build.SRC_DIR),
                    "-o", str(lib), str(src)], check=True, timeout=120)
    fn = ctypes.CDLL(str(lib)).keep_mask
    fn.argtypes = [ctypes.c_uint32, ctypes.c_uint32] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    b, h, sq, sk = 2, 3, 45, 70
    for seed in SEEDS:
        for rate in RATES:
            out = np.zeros((b, h, sq, sk), np.uint8)
            seed32, threshold, _ = tfa._dropout_args(rate, seed)
            fn(seed32, threshold, b, h, sq, sk, out.ctypes.data)
            want = tfa.dropout_keep_reference(seed, b, h, sq, sk, rate,
                                              device="cpu")
            np.testing.assert_array_equal(out.astype(bool), want.numpy())


def _segments(b, s):
    sid = np.zeros((b, s), np.int32)
    sid[0, 29:] = -1
    sid[1, 20:32] = 1
    sid[1, 32:] = -1
    return sid


@pytest.mark.parametrize("causal,seg,sq,sk,bias", [
    (True, False, 24, 40, False),     # end-aligned causal, sq != sk
    (False, False, 40, 40, False),
    (True, True, 40, 40, False),
    (False, True, 40, 40, False),
    (True, False, 40, 40, True),      # the bias with dropout (plain route)
])
def test_plain_forward_lse_and_grads_match_jax(causal, seg, sq, sk, bias):
    rng = np.random.RandomState(7)
    b, h, d = 2, 2, 16
    rate, seed = 0.3, -12345
    q, do = (rng.randn(b, h, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, sk, d).astype(np.float32) for _ in range(2))
    sid = _segments(b, sq) if seg else None
    bias_np = (rng.randn(1, h, sq, sk).astype(np.float32) if bias
               else None)
    scale = d ** -0.5
    jsid = None if sid is None else jnp.asarray(sid)
    jbias = None if bias_np is None else jnp.asarray(bias_np)

    def jf(qq, kk, vv):
        return jfa.flash_attention(
            qq, kk, vv, segment_ids_q=jsid, bias=jbias, causal=causal,
            scale=scale, dropout_rate=rate, dropout_seed=seed, block_q=16,
            block_k=16, block_q_bwd=16, block_k_bwd=16, interpret=True,
            autotune="off")

    import jax
    jout, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    _, jlse = jfa._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jsid, None, jbias,
        jnp.asarray([seed], jnp.int32), scale, causal, rate, 16, 16, True)

    tsid = None if sid is None else torch.from_numpy(sid)
    tbias = None if bias_np is None else torch.from_numpy(bias_np)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, segment_ids_q=tsid, causal=causal,
                              scale=scale, bias=tbias, dropout_rate=rate,
                              dropout_seed=seed)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    if not bias:
        _, lse = tfa.flash_attention_fwd(
            tq.detach(), tk.detach(), tv.detach(), tsid, None, causal, scale,
            rate, seed)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                                   atol=1e-5, rtol=1e-5)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), jgrads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-4 * float(np.abs(ref).max()),
                                   rtol=0)
    # dropout moved the output: not the no-dropout attention
    plain = tfa.mha_reference(tq.detach(), tk.detach(), tv.detach(),
                              causal=causal, segment_ids_q=tsid,
                              scale=scale, bias=tbias)
    assert not torch.allclose(out.detach(), plain)


def test_plain_backward_follows_the_jax_dropout_rule():
    """dv takes the dropped p, dp is masked and rescaled, ds takes the
    undropped p (``_p_dp_ds``): against the rule written out here."""
    rng = np.random.RandomState(3)
    b, h, s, d = 1, 2, 12, 8
    rate, seed = 0.5, 77
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
                   for _ in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_rate=rate,
                                       dropout_seed=seed)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                         dropout_rate=rate, dropout_seed=seed)
    keep = tfa.dropout_keep_reference(seed, b, h, s, s, rate, device="cpu")
    scale = d ** -0.5
    p = torch.softmax((q @ k.transpose(-1, -2) * scale).masked_fill(
        ~torch.ones(s, s, dtype=torch.bool).tril(), float("-inf")), dim=-1)
    pd = torch.where(keep, p / (1 - rate), torch.zeros_like(p))
    torch.testing.assert_close(out, pd @ v, atol=1e-6, rtol=1e-5)
    dp = torch.where(keep, (do @ v.transpose(-1, -2)) / (1 - rate),
                     torch.zeros_like(p))
    ds = p * (dp - (do * out).sum(-1, keepdim=True)) * scale
    torch.testing.assert_close(dv, pd.transpose(-1, -2) @ do, atol=1e-6,
                               rtol=1e-5)
    torch.testing.assert_close(dq, ds @ k, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(dk, ds.transpose(-1, -2) @ q, atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(dropout_rate=1.0, dropout_seed=1), r"must be in \[0, 1\)"),
    (dict(dropout_rate=-0.1, dropout_seed=1), r"must be in \[0, 1\)"),
    (dict(dropout_rate=0.1), "requires dropout_seed"),
])
def test_validation_errors_match_jax(kw, match):
    q = np.zeros((1, 2, 8, 16), np.float32)
    with pytest.raises(ValueError, match=match):
        jfa.flash_attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                            interpret=True, autotune="off", **kw)
    tq = torch.from_numpy(q)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(tq, tq, tq, **kw)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention_fwd(tq, tq, tq, **kw)


@pytest.mark.parametrize("dtype,kd,split,route", [
    (torch.bfloat16, 64, False, None),
    (torch.float16, 128, False, None),
    (torch.bfloat16, 64, True, None),
    (torch.float16, 128, True, None),
    (torch.float32, 64, False, "FFMA"),
    (torch.float32, 128, True, "FFMA"),
    (torch.bfloat16, 32, False, "frag.cuh"),
    (torch.bfloat16, 256, False, "frag.cuh"),
    (torch.float32, 512, False, "frag.cuh"),
])
def test_dropout_route_predicate_names_each_unported_route(dtype, kd, split,
                                                           route):
    """The route (None: the wgmma route) takes dropout or not by dtype and
    head dim: the wgmma route and the fp32 FFMA route take it in the
    forward, the single pass and the split alike; frag.cuh refuses it,
    naming the route. The backward's route agrees at a shape that splits
    (s4096) and one that does not (s64)."""
    refused = tfa.dropout_refusal(dtype, kd)
    takes = route in (None, "FFMA")
    if takes:
        assert refused is None
    else:
        assert route in refused
    s = 4096 if split else 64
    q = torch.zeros(1, 1, s, kd, dtype=dtype)
    assert tfa.uses_split_backward(s, s, kd, q.element_size(),
                                   q.element_size(), True,
                                   dropout=True) == split
    if takes:
        assert tfa._bwd_route(q, q, q, True, 0.1) == (split, dtype)
    else:
        with pytest.raises(NotImplementedError, match=route):
            tfa._bwd_route(q, q, q, True, 0.1)


def test_the_train_shape_keeps_the_single_pass_with_dropout():
    """b8 s1024 d64 bf16 causal: 786,432 + 1,048,576 B, under the gate, so
    the O2 GPT step's backward takes the single pass; s4096 splits."""
    assert tfa.backward_kv_bytes(1024, 1024, 64, causal=True,
                                 dropout=True) == 786_432 + 1_048_576
    assert not tfa.uses_split_backward(1024, 1024, 64, causal=True,
                                       dropout=True)
    assert tfa.uses_split_backward(4096, 4096, 64, causal=True, dropout=True)


def _stub_library(monkeypatch):
    """The C calls the wrappers make, recorded instead of run: ``(symbol,
    args)`` with the argument count checked against the argument types
    (CPU tensors stand for the card's; the stream is None)."""
    calls = []

    def function(target, symbol, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes), symbol
            calls.append((target, symbol, args))
            return 0
        return fn

    monkeypatch.setattr(tfa._build, "function", function)
    monkeypatch.setattr(tfa, "_stream", lambda t: None)
    return calls


def test_cuda_wrappers_refuse_unported_routes_before_any_launch(
        monkeypatch):
    """The kernel wrappers raise ``NotImplementedError`` naming the route
    before they reach the card (CPU tensors reach the check and stop
    there): the fp32 split over a bf16 dout (frag.cuh, which rounds p to
    dout's dtype), the fp32 forward over a bf16 v (frag.cuh, which rounds p
    to v's dtype), bf16 at d 32 (frag.cuh); the
    split backward at s4096 takes the wgmma split, dq (with the delta
    fold) then dk/dv, each with the dropout's seed, threshold and 1 / (1 -
    rate) and counted on its dropout counter."""
    q = torch.zeros(1, 2, 16, 64)
    with pytest.raises(NotImplementedError, match="frag.cuh"):
        tfa._flash_fwd_cuda(q, q, q.bfloat16(), None, None, True, 0.125,
                            dropout_rate=0.1, dropout_seed=1)
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(NotImplementedError, match="frag.cuh"):
        tfa._flash_bwd_cuda(q, q, q, q, lse, q.bfloat16(), None, None, True,
                            0.125, split=True, dropout_rate=0.1,
                            dropout_seed=1)
    q32 = torch.zeros(1, 2, 16, 32, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="frag.cuh"):
        tfa._flash_fwd_cuda(q32, q32, q32, None, None, True, 0.125,
                            dropout_rate=0.1, dropout_seed=1)
    qs = torch.zeros(1, 1, 4096, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 4096)
    calls = _stub_library(monkeypatch)
    g = tfa.flash_attention_bwd
    n0 = (g.dropout_dkdv_launches, g.dropout_dq_launches,
          g.dropout_launches, g.launches)
    tfa._flash_bwd_cuda(qs, qs, qs, qs, lse, qs, None, None, True, 0.125,
                        dropout_rate=0.1, dropout_seed=-1)
    assert [c[1] for c in calls] == ["apex_flash_bwd_sm90_dq",
                                     "apex_flash_bwd_sm90_dkdv"]
    drop = tfa._dropout_args(0.1, -1)
    for target, _, args in calls:
        assert target == "flash_bwd_sm90@bf16"
        assert args[-4:-1] == drop and args[-1] is None
    assert (g.dropout_dkdv_launches - n0[0], g.dropout_dq_launches - n0[1],
            g.dropout_launches - n0[2], g.launches - n0[3]) == (1, 1, 0, 0)
    # rate 0 keeps threshold 0: the kernels' code without dropout
    calls.clear()
    tfa._flash_bwd_cuda(qs, qs, qs, qs, lse, qs, None, None, True, 0.125)
    assert [c[2][-4:-1] for c in calls] == [(0, 0, 1.0)] * 2
    assert (g.dropout_dkdv_launches, g.dropout_dq_launches) == (
        n0[0] + 1, n0[1] + 1)


def test_backward_route_is_decided_once_for_the_wrapper_and_the_kernels():
    """``_bwd_route`` is what ``flash_attention`` checks before the forward
    and what ``_flash_bwd_cuda`` routes by: the single pass in bf16 at the
    train shape, the split at s4096 with dropout as without, and mixed
    operands promoted to fp32 (which round p or ds: the frag.cuh kernels,
    refused) whatever ``do`` is."""
    q = torch.zeros(8, 16, 1024, 64, dtype=torch.bfloat16)
    assert tfa._bwd_route(q, q, q, True, 0.1) == (False, torch.bfloat16)
    assert tfa._bwd_route(q, q, q, True, 0.1, q) == (False, torch.bfloat16)
    qs = torch.zeros(1, 1, 4096, 64, dtype=torch.bfloat16)
    assert tfa._bwd_route(qs, qs, qs, True, 0.0) == (True, torch.bfloat16)
    assert tfa._bwd_route(qs, qs, qs, True, 0.1) == (True, torch.bfloat16)
    k32 = torch.zeros(8, 16, 1024, 64)
    for do in (None, q, k32):
        with pytest.raises(NotImplementedError, match="frag.cuh"):
            tfa._bwd_route(q, k32, q, True, 0.1, do)


def test_keep_mask_runs_on_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    """Like every ``device=None`` of the port (``_compat.resolve_device``):
    CUDA by default, and an error, not the CPU, where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfa.dropout_keep_reference(1, 1, 1, 4, 4, 0.5)
    assert tfa.dropout_keep_reference(1, 1, 1, 4, 4, 0.5,
                                      device="cpu").device.type == "cpu"


def test_bias_with_dropout_keeps_the_plain_route_and_a_zero_gradient():
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 12, 8).astype(np.float32))
               .requires_grad_() for _ in range(3))
    bias = torch.from_numpy(rng.randn(1, 2, 12, 12).astype(np.float32))
    bias.requires_grad_()
    out = tfa.flash_attention(q, k, v, bias=bias, causal=True,
                              dropout_rate=0.2, dropout_seed=3)
    ref = tfa.mha_reference(q, k, v, bias=bias, causal=True,
                            dropout_rate=0.2, dropout_seed=3)
    assert torch.equal(out, ref)
    out.sum().backward()
    assert torch.equal(bias.grad, torch.zeros_like(bias))
    assert all(t.grad is not None for t in (q, k, v))
