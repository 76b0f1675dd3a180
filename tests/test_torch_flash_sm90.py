"""The flash forward and single-pass backward on the wgmma/TMA route, on
the CPU.

The forward runs ``csrc/flash_fwd_sm90.cu`` and the single-pass backward
``flash_bwd_fused_sm90`` of ``csrc/flash_bwd_sm90.cu`` for bf16 and fp16
at kernel head dims 64 and 128 (``sm90_route``, the same predicate as the
split's ``split_route``), and ``csrc/flash_fwd.cu`` / ``csrc/flash_bwd.cu``
for everything else: fp32, operands of mixed dtypes (promoted to fp32
first), head dims 32, 256 and 512. The forward's rows a block follow from
the shape alone (``fwd_block_rows``: the head dim, and blocks against
SMs). The new source is built for bf16 and fp16 only, for ``sm_90a``.
The kernels themselves run on the card (``tests/test_torch_cuda_kernels.py``);
the plain versions they are held against are held against the JAX package
in ``tests/test_torch_flash_attention.py``.
"""

import pytest
import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import flash_attention as tfa

_FWD = "flash_fwd_sm90"
_BWD = "flash_bwd_sm90"


@pytest.mark.parametrize("kd", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_sm90_route_by_dtype_and_kernel_head_dim(dtype, kd):
    """One predicate routes the forward, the single pass and the split."""
    wgmma = dtype != torch.float32 and kd in (64, 128)
    assert tfa.sm90_route(dtype, kd) is wgmma
    assert tfa.split_route(dtype, kd) == (_BWD if wgmma else "flash_bwd")


@pytest.mark.parametrize("d,wgmma", [
    (1, False), (32, False), (33, True), (40, True), (64, True),
    (65, True), (80, True), (96, True), (128, True), (129, False),
    (200, False), (256, False), (320, False), (512, False)])
def test_sm90_route_of_padded_head_dims(d, wgmma):
    """Any d runs at ``kernel_head_dim(d)``: 33-128 pad onto the wgmma
    route's 64 and 128 (d 40 -> 64, d 80 -> 128); 32 and below, and past
    128, stay on flash_fwd.cu and flash_bwd.cu."""
    kd = tfa.kernel_head_dim(d)
    for dtype in (torch.bfloat16, torch.float16):
        assert tfa.sm90_route(dtype, kd) is wgmma
    assert tfa.sm90_route(torch.float32, kd) is False
    if d in (40, 80):
        assert kd == {40: 64, 80: 128}[d]


@pytest.mark.parametrize("dtypes", [
    (torch.bfloat16, torch.float16, torch.bfloat16),
    (torch.float16, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float16),
    (torch.float32, torch.bfloat16, torch.bfloat16)])
def test_mixed_operands_stay_on_the_old_sources(dtypes):
    """q, k, v of more than one dtype are promoted to fp32 (exact), which
    takes flash_fwd.cu and flash_bwd.cu at every head dim."""
    ts = [torch.zeros(1, 1, 4, 64, dtype=dt) for dt in dtypes]
    promoted, dtype = tfa._promoted(*ts)
    assert dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in promoted)
    for kd in (32, 64, 128, 256, 512):
        assert not tfa.sm90_route(dtype, kd)


@pytest.mark.parametrize("bh,sq,kd,sms,rows", [
    (16, 512, 64, 132, 64),       # the serve prefill
    (128, 1024, 64, 132, 64),     # b8 h16 s1024: two blocks an SM at d 64
    (32, 4096, 64, 132, 64),      # b2 h16 s4096
    (16, 512, 128, 132, 64),      # 64 blocks of 128 rows: SMs idle
    (32, 512, 128, 132, 64),      # 128 blocks
    (33, 512, 128, 132, 128),     # 132 blocks: the SMs are filled
    (33, 511, 128, 132, 128),
    (64, 1024, 128, 132, 128),
    (1, 1, 128, 132, 64),
    (16, 512, 128, 64, 128),      # a card of 64 SMs
])
def test_fwd_block_rows_follow_the_shape(bh, sq, kd, sms, rows):
    assert tfa.fwd_block_rows(bh, sq, kd, sms) == rows


def test_block_rows_is_refused_off_the_wgmma_route():
    q = torch.zeros(1, 2, 16, 64)
    with pytest.raises(ValueError, match="block_rows"):
        tfa._flash_fwd_cuda(q, q, q, None, None, True, 0.125, block_rows=64)
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="block_rows"):
        tfa._flash_fwd_cuda(qb, qb, qb, None, None, True, 0.125,
                            block_rows=96)
    qd = torch.zeros(1, 2, 16, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block_rows"):
        tfa._flash_fwd_cuda(qd, qd, qd, None, None, True, 0.0625,
                            block_rows=128)


def test_build_targets_hold_bf16_and_fp16_only():
    assert _build.DTYPE_SPLIT[_FWD] == (0, 1)
    assert _build.targets([_FWD]) == [f"{_FWD}@bf16", f"{_FWD}@f16"]
    with pytest.raises(ValueError, match="not built for f32"):
        _build.dtype_target(_FWD, 2)
    # the mma.sync/SIMT forward keeps all three dtypes
    assert _build.targets(["flash_fwd"]) == [
        "flash_fwd@bf16", "flash_fwd@f16", "flash_fwd@f32"]


def test_build_command_compiles_the_forward_for_sm90a(tmp_path,
                                                      monkeypatch):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    for target, code in zip(_build.targets([_FWD]), (0, 1)):
        cmd = _build.nvcc_command(target, tmp_path / "lib.so")
        assert cmd[0] == str(nvcc)
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert f"-DAPEX_DTYPE={code}" in cmd
        assert cmd[-1] == str(_build.SRC_DIR / f"{_FWD}.cu")
    src = (_build.SRC_DIR / f"{_FWD}.cu").read_text()
    assert '#include "wgmma_attn.cuh"' in src
    assert 'extern "C" int apex_flash_fwd_sm90(' in src
    # the single pass is a kernel of the split's source
    assert 'extern "C" int apex_flash_bwd_sm90_fused(' in \
        (_build.SRC_DIR / f"{_BWD}.cu").read_text()


def _counts():
    f, b = tfa.flash_attention, tfa.flash_attention_bwd
    return (f.launches, f.wgmma_launches, b.launches, b.wgmma_launches,
            b.dkdv_launches, b.dq_launches, b.wgmma_dkdv_launches,
            b.wgmma_dq_launches)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.float16, 128),
                                     (torch.bfloat16, 80),
                                     (torch.float32, 64)])
def test_cpu_calls_count_no_launch(dtype, d):
    """The CPU path runs the plain versions and counts nothing, on either
    route's dtype and head dim, through autograd too."""
    before = _counts()
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 2, 40, d, generator=g).to(dtype)
                   for _ in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    tfa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    qs = [t.detach().requires_grad_() for t in (q, k, v)]
    tfa.flash_attention(*qs, causal=True).float().sum().backward()
    assert _counts() == before


def test_wgmma_counters_exist_and_stay_zero_on_the_cpu():
    """The wgmma route's counters sit beside the old ones; nothing on the
    CPU moves them."""
    assert tfa.flash_attention.wgmma_launches == 0
    assert tfa.flash_attention_bwd.wgmma_launches == 0
