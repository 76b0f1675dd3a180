"""The zero padding the kernel wrappers add is exact: each wrapper's
pad-and-slice helper, run with the plain version as the inner function,
gives the unpadded plain result bit for bit.

- flash attention: the head dim padded to the kernels' next instantiation
  (``kernel_head_dim``: 80 and 96 -> 128, 48 -> 64, 200 -> 256), forward
  and backward, with the caller's scale;
- the LM-head CE: the hidden size padded to the kernels' chunk multiple
  (``hidden_chunks``: 100 -> 128, 1600 -> 1664 in bf16 and 1792 in fp32),
  forward statistics and both gradients;
- the fp8 dequant-matmul: K and N padded to multiples of 16
  (``with_padded_kn``), K = N = 1000 -> 1008.

The inputs are dyadic (small integers times powers of two) so that every
sum over a padded axis is exact in fp32 in any order: the comparison then
shows that the zeros add nothing and that the slices cut the right
columns, whatever blocking the CPU's matrix products choose for the two
widths (with random fp32 inputs the CPU's products may sum a wider
contraction in another order).
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.amp import fp8
from apex_tpu_torch.ops import flash_attention as fa
from apex_tpu_torch.ops import fp8_matmul as mm
from apex_tpu_torch.ops import lm_head_ce as ce
from apex_tpu_torch.ops._pad import pad_last_dim, with_padded_last_dim


def _dyadic(rng, *shape, scale=8, lo=-8, hi=9):
    return torch.from_numpy(
        (rng.randint(lo, hi, size=shape) / scale).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [48, 80, 96, 200])
def test_flash_head_dim_padding_is_exact(dtype, d):
    rng = np.random.RandomState(d)
    q, k, v, do, o = (_dyadic(rng, 2, 3, 37, d).to(dtype) for _ in range(5))
    dp = fa.kernel_head_dim(d)
    assert dp > d and dp in (64, 128, 256)
    scale = d ** -0.5

    def fwd(q, k, v):
        return fa.flash_attention_reference(q, k, v, causal=True,
                                            scale=scale)

    ref = fwd(q, k, v)
    got = with_padded_last_dim(fwd, dp, (q, k, v), sliced=(0,))
    assert got[0].shape == q.shape
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    lse = ref[1]

    def bwd(q, k, v, o, do):
        return fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                causal=True, scale=scale)

    ref_g = bwd(q, k, v, o, do)
    got_g = with_padded_last_dim(bwd, dp, (q, k, v, o, do),
                                 sliced=(0, 1, 2))
    for a, b in zip(got_g, ref_g):
        assert a.shape == b.shape and torch.equal(a, b)


def test_kernel_head_dim_steps_and_limit():
    assert [fa.kernel_head_dim(d) for d in (8, 32, 33, 64, 65, 128, 129,
                                            256)] == [32, 32, 64, 64, 128,
                                                      128, 256, 256]
    with pytest.raises(ValueError, match="head dim 257"):
        fa.kernel_head_dim(257)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [64, 100, 1600])
def test_lm_head_hidden_padding_is_exact(dtype, h):
    rng = np.random.RandomState(h)
    n, V = 33, 70
    x = _dyadic(rng, n, h).to(dtype)
    e = _dyadic(rng, V, h, scale=64).to(dtype)
    tgt = torch.from_numpy(rng.randint(0, V, n).astype(np.int32))
    hp, kc = ce.hidden_chunks(h, dtype)
    assert hp % kc == 0 and kc % 64 == 0 and hp >= h
    assert kc <= (512 if dtype == torch.float32 else 1024)

    def fwd(x, e):
        return ce.lm_head_ce_fwd_reference(x, e, tgt, True)

    ref = fwd(x, e)
    got = with_padded_last_dim(fwd, hp, (x, e))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    m, l = ref[0], ref[1]
    dl = torch.full((n,), 1.0 / 32)

    def bwd(x, e):
        return ce.lm_head_ce_bwd_reference(x, e, tgt, m, l, dl, 0.1)

    ref_g = bwd(x, e)
    got_g = with_padded_last_dim(bwd, hp, (x, e), sliced=(0, 1))
    for a, b in zip(got_g, ref_g):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_hidden_chunks_choose_fewest_chunks_then_least_padding():
    bf, f32 = torch.bfloat16, torch.float32
    assert ce.hidden_chunks(64, bf) == (64, 64)
    assert ce.hidden_chunks(1024, bf) == (1024, 1024)
    assert ce.hidden_chunks(1536, bf) == (1536, 768)
    assert ce.hidden_chunks(1600, bf) == (1664, 832)
    assert ce.hidden_chunks(2048, bf) == (2048, 1024)
    assert ce.hidden_chunks(1024, f32) == (1024, 512)


@pytest.mark.parametrize("m,K,N", [(8, 1000, 1000), (5, 40, 24),
                                   (3, 1024, 1000)])
def test_fp8_kn_padding_is_exact(m, K, N):
    rng = np.random.RandomState(K + N)
    x = _dyadic(rng, m, K).to(torch.bfloat16)
    # small integers are exact in e4m3; a power-of-two scale divides out
    q = _dyadic(rng, K, N, scale=1).to(fp8.E4M3)
    scale = torch.tensor(4.0)
    ref = mm.fp8_dequant_matmul_reference(x, q, scale)
    got = mm.with_padded_kn(mm.fp8_dequant_matmul_reference, x, q, scale,
                            torch.bfloat16)
    assert got.shape == (m, N) and torch.equal(got, ref)


def test_pad_last_dim_pads_zeros_and_fp8_bytes():
    t = torch.arange(6.0).reshape(2, 3)
    p = pad_last_dim(t, 5)
    assert p.shape == (2, 5) and torch.equal(p[:, :3], t)
    assert (p[:, 3:] == 0).all() and pad_last_dim(t, 3) is t
    q = t.to(fp8.E4M3)
    pq = pad_last_dim(q, 4)
    assert pq.dtype == fp8.E4M3 and (pq[:, 3].float() == 0).all()
    assert torch.equal(pq[:, :3].float(), q.float())
    with pytest.raises(ValueError, match="cannot pad"):
        pad_last_dim(t, 2)
