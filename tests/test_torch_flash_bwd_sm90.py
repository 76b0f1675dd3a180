"""The flash backward's two-kernel split and its two routes, on the CPU.

The split runs ``csrc/flash_bwd_sm90.cu`` (wgmma/TMA) for bf16 and fp16 at
kernel head dims 64 and 128, and ``csrc/flash_bwd.cu`` for everything
else: fp32, operands of mixed dtypes (promoted to fp32 first), head dims
32, 256 and 512. The route is a pure function of the promoted dtype and
the kernel head dim (``split_route``), and the new source is built for
bf16 and fp16 only. The kernels themselves run on the card
(``tests/test_torch_cuda_kernels.py``).

On the wgmma route the dq kernel computes delta = rowsum(do * o) for its
own rows (the delta fold) and runs before dk/dv, which reads it. The
fold's plain versions (``flash_bwd_dq_reference``, then
``flash_bwd_dkdv_reference`` on its delta) are held against the JAX
package's two-kernel split in Pallas interpret mode: fp32 within 1e-5 of
the largest gradient (fp32 math on both sides, other summation order);
bf16 within two bf16 ulps plus 2 % of the largest (the Pallas kernels
round p and ds to bf16 before their products, the plain versions keep
fp32).
"""

import importlib

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("apex_tpu.ops.flash_attention")

_SM90 = "flash_bwd_sm90"
_MMA = "flash_bwd"


@pytest.mark.parametrize("kd", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_split_route_by_dtype_and_kernel_head_dim(dtype, kd):
    wgmma = dtype != torch.float32 and kd in (64, 128)
    assert tfa.split_route(dtype, kd) == (_SM90 if wgmma else _MMA)


@pytest.mark.parametrize("d,route", [
    (1, _MMA), (32, _MMA), (33, _SM90), (48, _SM90), (64, _SM90),
    (65, _SM90), (80, _SM90), (96, _SM90), (128, _SM90), (129, _MMA),
    (200, _MMA), (256, _MMA), (320, _MMA), (512, _MMA)])
def test_split_route_of_padded_head_dims(d, route):
    """Any d runs at ``kernel_head_dim(d)``: 33-128 pad onto the wgmma
    route's 64 and 128; 32 and below, and past 128, stay on flash_bwd.cu."""
    for dtype in (torch.bfloat16, torch.float16):
        assert tfa.split_route(dtype, tfa.kernel_head_dim(d)) == route
    assert tfa.split_route(torch.float32, tfa.kernel_head_dim(d)) == _MMA


@pytest.mark.parametrize("dtypes", [
    (torch.bfloat16, torch.float16, torch.bfloat16, torch.bfloat16),
    (torch.float16, torch.bfloat16, torch.bfloat16, torch.float16),
    (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float16, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float16)])
def test_mixed_operands_stay_on_flash_bwd(dtypes):
    """q, k, v, do of more than one dtype are promoted to fp32 (exact),
    and fp32 takes flash_bwd.cu at every head dim."""
    ts = [torch.zeros(1, 1, 4, 64, dtype=dt) for dt in dtypes]
    promoted, dtype = tfa._promoted(*ts)
    assert dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in promoted)
    for kd in (32, 64, 128, 256, 512):
        assert tfa.split_route(dtype, kd) == _MMA


def test_one_dtype_operands_keep_their_dtype_and_route():
    for dt in (torch.bfloat16, torch.float16):
        ts = [torch.zeros(1, 1, 4, 64, dtype=dt) for _ in range(4)]
        assert tfa._promoted(*ts)[1] == dt
        assert tfa.split_route(dt, 64) == _SM90


def test_build_targets_hold_bf16_and_fp16_only():
    assert _build.DTYPE_SPLIT[_SM90] == (0, 1)
    assert _build.targets([_SM90]) == [f"{_SM90}@bf16", f"{_SM90}@f16"]
    with pytest.raises(ValueError, match="not built for f32"):
        _build.dtype_target(_SM90, 2)
    # the mma.sync/SIMT split keeps all three dtypes
    assert _build.targets([_MMA]) == [f"{_MMA}@bf16", f"{_MMA}@f16",
                                      f"{_MMA}@f32"]


def test_build_command_compiles_the_new_source_for_sm90a(tmp_path,
                                                         monkeypatch):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    for target, code in zip(_build.targets([_SM90]), (0, 1)):
        cmd = _build.nvcc_command(target, tmp_path / "lib.so")
        assert cmd[0] == str(nvcc)
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert f"-DAPEX_DTYPE={code}" in cmd
        assert cmd[-1] == str(_build.SRC_DIR / f"{_SM90}.cu")
    # its header beside the core is part of every library's key
    assert '#include "wgmma_attn.cuh"' in \
        (_build.SRC_DIR / f"{_SM90}.cu").read_text()
    assert (_build.SRC_DIR / "wgmma_attn.cuh").is_file()


def test_cpu_backward_counts_no_launch():
    f = tfa.flash_attention_bwd
    before = (f.launches, f.dkdv_launches, f.dq_launches,
              f.wgmma_dkdv_launches, f.wgmma_dq_launches)
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 2, 40, 64, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    tfa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    assert (f.launches, f.dkdv_launches, f.dq_launches,
            f.wgmma_dkdv_launches, f.wgmma_dq_launches) == before


def test_rs_probe_refuses_what_it_does_not_take():
    a = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="want a"):
        tfa.wgmma_rs_probe(a, torch.zeros(96, 64, dtype=torch.bfloat16),
                           False)
    with pytest.raises(ValueError, match="want a"):
        tfa.wgmma_rs_probe(torch.zeros(32, 64, dtype=torch.bfloat16),
                           torch.zeros(64, 64, dtype=torch.bfloat16), True)


@pytest.mark.parametrize("features,dtype", [
    ("causal", "float32"), ("segments", "float32"), ("full", "float32"),
    ("causal", "bfloat16"), ("segments", "bfloat16")])
def test_plain_fold_matches_jax_two_kernel_split(features, dtype,
                                                 monkeypatch):
    """JAX forced onto its split (``_FUSED_BWD_MAX_KV_BYTES`` = 0) in
    interpret mode at s256 d64 against the fold's plain versions: dq and
    delta from q, k, v, o, lse, do; dk, dv from that delta."""
    rng = np.random.RandomState(8)
    b, h, s, d = 1, 2, 256, 64
    q, k, v, do = (rng.randn(b, h, s, d).astype(np.float32)
                   for _ in range(4))
    kw, tkw = {}, {}
    if features != "full":
        kw["causal"] = tkw["causal"] = True
    if features == "segments":
        sid = (rng.randint(0, 3, (b, s)).cumsum(-1) // 2).astype(np.int32)
        sid[:, -24:] = -1                                   # padding rows
        kw.update(segment_ids_q=jnp.asarray(sid))
        tkw.update(segment_ids_q=torch.from_numpy(sid))
    monkeypatch.setattr(jfa, "_FUSED_BWD_MAX_KV_BYTES", 0)
    if dtype == "bfloat16":
        jarr = [jnp.asarray(a.astype(ml_dtypes.bfloat16)) for a in
                (q, k, v, do)]
        tarr = [torch.from_numpy(a).to(torch.bfloat16) for a in
                (q, k, v, do)]
    else:
        jarr = [jnp.asarray(a) for a in (q, k, v, do)]
        tarr = [torch.from_numpy(a) for a in (q, k, v, do)]

    def jf(qq, kk, vv):
        return jfa.flash_attention(qq, kk, vv, block_q=128, block_k=128,
                                   block_q_bwd=128, block_k_bwd=128,
                                   interpret=True, autotune="off", **kw)

    _, vjp = jax.vjp(jf, *jarr[:3])
    jgrads = vjp(jarr[3])
    tq, tk, tv, tdo = tarr
    out, lse = tfa.flash_attention_reference(tq, tk, tv, **tkw)
    dq, delta = tfa.flash_bwd_dq_reference(tq, tk, tv, out, lse, tdo, **tkw)
    dk, dv = tfa.flash_bwd_dkdv_reference(tq, tk, tv, lse, delta, tdo,
                                          **tkw)
    want = (tdo.float() * out.float()).sum(-1)
    assert delta.dtype == torch.float32 and delta.shape == (b, h, s)
    np.testing.assert_allclose(delta.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    for got, ref in zip((dq, dk, dv), jgrads):
        assert got.dtype == tq.dtype
        g = got.float().numpy()
        r = np.asarray(ref, np.float32)
        scale = float(np.abs(r).max())
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=1e-5 * scale, rtol=0)
        else:
            tol = np.abs(r) * 2 * 2.0 ** -7 + 2e-2 * scale
            assert np.all(np.abs(g - r) <= tol), float(np.abs(g - r).max())


@pytest.mark.parametrize("features", ["causal", "segments"])
def test_fold_composes_to_the_plain_backward(features):
    """dq with its folded delta, then dk/dv on that delta, is the plain
    backward (the same operations; bitwise on the CPU)."""
    g = torch.Generator().manual_seed(3)
    b, h, s, d = 2, 2, 48, 64
    q, k, v, do = (torch.randn(b, h, s, d, generator=g) for _ in range(4))
    kw = dict(causal=True)
    if features == "segments":
        sid = torch.zeros(b, s, dtype=torch.int32)
        sid[:, 20:] = 1
        sid[1, 40:] = -1
        kw["segment_ids_q"] = sid
    out, lse = tfa.flash_attention_reference(q, k, v, **kw)
    ref = tfa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    dq, delta = tfa.flash_bwd_dq_reference(q, k, v, out, lse, do, **kw)
    dk, dv = tfa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do, **kw)
    for got, want in zip((dq, dk, dv), ref):
        assert torch.equal(got, want)
