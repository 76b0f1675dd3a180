#!/usr/bin/env python3
"""Drive ``apex_tpu_torch`` on one NVIDIA GPU and hold its kernels against
their plain PyTorch versions.

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
(``/usr/local/cuda``) and ``triton``::

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is caught):

1. set-up — build the CUDA kernels from ``apex_tpu_torch/csrc`` (one
   ``nvcc`` per source and dtype, started together), count the ``HGMMA``
   instructions in the wgmma libraries, the LM-head CE's and the flash
   forward's and backward's (``cuobjdump -sass``; none fails), turn TF32
   off, print the card's name and power limit; the
   fp8 codec's e4m3 cast and scale on the card against the CPU's,
   bitwise;
2. kernels — each kernel's wrapper at its main path's shapes against its
   plain version on the same inputs, with the tolerance stated beside each
   check, timed with CUDA events (L2 flushed before every launch, and a
   device sleep queued before the start event, so that the pair holds
   device time only) beside
   its plain version, a PyTorch library call where one computes the same
   function, and its bound (the least time for its bytes at 3.35 TB/s or
   its operations at 989 TFLOP/s bf16, whichever is larger);
3. serve paths — three ``ServeEngine``s, each after a warm-up engine and
   with the launch counters reset just before, serve 16 requests (prompts
   of 64-512 tokens, 64 new tokens each) through the 12-layer h1024 GPT
   (``bench.py``'s ``_bench_gpt`` shape, random weights from seed 0): the
   bf16 engine, ``fp8_weights`` + ``fp8_kv``, and ``fp8_weights`` +
   ``spec_k=4`` (6-layer draft); asserts every request's length, that
   every page went back, and each kernel's exact launch count; prints
   tokens/s, decode-step and prefill times, pool bytes, the accept rate;
4. serve checks — for two finished requests of the bf16 and the fp8
   engine, the no-cache forward through the plain versions of every kernel
   (over the same e4m3 weights for the fp8 engine), over prompt + generated
   tokens, against the engine's recorded logits; the speculative engine's
   tokens against a plain ``fp8_weights`` engine's;
5. train path — the same GPT trained at O2 (bf16 model, fp32 master
   weights, dynamic loss scale) with ``FusedAdam`` through
   ``amp.make_train_step`` on one fixed b8 s1024 batch: a warm-up step,
   then 8 timed steps with the launch counters reset just before; asserts
   the losses are finite and fall, the scale never moved and each kernel's
   launches per step (every flash forward and single-pass backward on the
   wgmma route); prints step-time median, p90 and tokens/s;
6. gradient check — from the same initial parameters, the loss and every
   parameter's gradient through the kernels against
   ``GPT.loss(reference=True)`` (the plain versions, differentiated by
   autograd);
7. overflow — one step whose gradients overflow fp32 leaves the master
   weights, the moments and the step counter bitwise unchanged and halves
   the scale;
8. trace — ``torch.profiler`` over decode steps and prefills of the bf16
   and the fp8 engine and over train steps, and the train step's device
   time by phase (forward + backward, unscale, optimizer, scaler update)
   from CUDA events;
9. long-sequence train path — the same GPT at O2 with ``FusedAdam`` at
   b2 s4096 (``bench.py``'s ``_bench_gpt_long_seq``), where the flash
   backward takes its two-kernel split: a warm-up step, then 4 timed steps
   with the counters reset just before; asserts finite losses and per
   step 12 dq and 12 dk/dv launches, every one on the wgmma route
   (``csrc/flash_bwd_sm90.cu``), and no single-pass one; traced;
10. ResNet-50 path — ``bench.py``'s ``_build_step`` at b256 224x224: O2
    (bf16 convs, fp32 batch norms and statistics, fp32 masters),
    ``FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)``, the mean of
    ``softmax_cross_entropy_with_smoothing(logits, y, 0.1)``, inputs and
    labels from numpy seed 0: a warm-up step, then 8 timed steps with the
    counters reset just before; asserts finite losses, one launch of each
    cross-entropy kernel per step and fp32 batch norms; prints images/s;
    traced; then an overflowing step (skipped bitwise: masters, momentum
    buffers and their flag; the scale halved) and one step's loss and
    gradients through the kernels against the plain twin;
11. ZeRO-3 path — the same GPT at b8 s1024 through ``amp.initialize(...,
    zero=True)`` with ``ZeroOptimizer(adam, shard_params=True,
    weight_decay=0.01)`` and ``zero.make_train_step`` at world 1: a warm-up
    step, then 8 timed steps with the counters reset just before; asserts
    finite falling losses and one fused-update (B13) launch a step; the
    masters, m and v after the warm-up step and after all 9 against the
    dense FusedAdam step of phase 5 from the same fp32 init; the step's
    device time by phase beside the dense FusedAdam's in this run; traced;
    then an
    overflowing step (shards, masters, m, v, step bitwise unchanged, the
    scale halved);
12. tier-2 LAMB path — ``DistributedFusedLAMB(lr=1e-3, weight_decay=0.01,
    max_grad_norm=1.0)`` through ``amp.make_train_step`` at O2: a warm-up,
    3 counted steps (one B13 LAMB launch each), then one step on the card
    against the same step of a CPU twin;
13. probe path — ``apex_tpu_torch.scripts.vpu_probe``'s run: each of the
    six ops (B14) chained 16 times over [64, 512, 512] fp32 and summed,
    timed as the script times it; asserts the launch count;
14. bottleneck path — ``apex_tpu_torch.scripts.bottleneck_proto``'s run at
    the proto's full shape (N 32, 56 x 56 x 256 bf16): the fused kernel
    (B15) within the proto's 0.15 of the cuDNN composition, both timed;
15. spatial path — ``contrib.bottleneck.SpatialBottleneck`` at world 1 at
    ResNet-50's conv2_x width (x [32, 256, 56, 56] bf16, fp32 norms):
    forward and backward against ``models.resnet.Bottleneck`` with the
    same weights, then 4 O2 ``FusedSGD`` steps with a finite, falling
    loss;
16. O0 path — the GPT at full width with 2 layers in fp32 (b8 s1024): the
    loss and every gradient through the kernels (fp32 flash, LayerNorm and
    LM-head CE) against ``GPT.loss(reference=True)``, then 3 counted
    ``FusedAdam`` steps through ``amp.make_train_step`` at O0 (the CE on
    its fp32 kernels), and one more under ``torch.profiler``: its device
    time by kernel class;
17. O0 long path — the same 2-layer fp32 GPT at b2 s4096, past the
    flash backward's gate: a warm-up and 2 counted O0 steps, every split
    launch on ``csrc/flash_bwd.cu``'s route (fp32 takes no wgmma).

The kernel phase also holds the shapes and dtypes ROADMAP §C records as
repaired against the plain versions: flash forward and backward (single
pass and split) at fp16 and fp32, at head dims 80, 96, 256, 320 and 512
(fp32 included), and over q, k, v of mixed dtypes; paged decode at group
16 in both pool modes, with fp16/fp32 queries, at head dims 80, 96, 100,
256 and 512 in both pool modes and with queries over a pool of another
dtype; the LM-head CE (B8 and B9 on wgmma/TMA for bf16 and fp16, the
FFMA route for fp32) at h 64, 100, 1536, 1600, 2048, fp16 and fp32 (and
fp32 at 1601 over a ragged 1000 x 1003), and B9 bitwise on a second run,
its device launches in one call counted by ``torch.profiler`` (each of
its three products once a token chunk, no other kernel); the fp8 matmul
at K = N = 1000. And B15 (the fused
bottleneck, N 32) within two bf16 ulps plus 2^-5 of its plain version and
0.15 of the cuDNN composition; B14
bitwise (mul, max, where, iota_cmp_where) or within 2 ulps (exp, exp2).

The flash forward and single-pass backward are held on both routes: the
wgmma route (``csrc/flash_fwd_sm90.cu``; ``flash_bwd_fused_sm90`` of
``csrc/flash_bwd_sm90.cu``) at the serve prefill's, the s1024 and the
s4096 train cells' shapes, ragged shapes, fp16 and a padded head dim, the
forward and the single pass's dk and dv bitwise on a rerun, with ptxas's
registers and no spill; flash_fwd.cu's and flash_bwd.cu's in fp32 at the
O0 path's shape. Every bf16 main path (the GPT cells, ZeRO-3, LAMB,
serve) takes the wgmma route for every flash launch, the O0 paths none.

B8 and B9's fp32 route (``csrc/lm_head_ce.cu`` on the exact-FFMA core of
``csrc/simt_f32.cuh``) is held at the O0 path's n 8192, V 32768, h 1024
against its plain versions, bitwise on a rerun, with its device launches
counted and ptxas's log showing no spill, and timed beside the fp32
library composition (TF32 off). The single-pass flash backward's dq is
bitwise on a rerun on both routes and, for one batch, the same bits run
alone.

It holds B13 bitwise against its plain version in five modes and under a
set skip flag, at the GPT's 185,759,744 parameters and a ragged n. The
split flash backward (B3, B4) is held on both routes: the wgmma route
(bf16, b2 h16 s4096 d64 causal and a b1 h4 s2304 segment case) kernel by
kernel against its plain versions (dq with the delta it folds in, dk/dv
from that delta), as a pair against the plain backward and bitwise on a
rerun, with each kernel's ``ptxas`` register count; flash_bwd.cu's route
in fp32 at the same shape; both timed apart, and the split beside the
single pass at b8 h16 s1024.

The decode kernels (B12's decode regime, ``csrc/fp8_matmul.cu``; B5,
``csrc/paged_decode.cu``) are held at the serve engines' shapes: B12 at
the four block linears at m 8 beside bf16 ``torch.matmul`` on the
unquantized weight, B5 in both pool modes at the mixed batch, the
speculative engine's draft call (one active row of 300 keys) and verify
call (five rows of one sequence at 300-304 keys), each beside its bound;
``torch.profiler`` counts one device launch a call of each, and ptxas's
log shows no spill in any of their kernels. The speculative engine's
recorded logits rows must all be bitwise the plain engine's, and each
serve engine's decode step is traced (device time beside wall time).

The second-last line of standard output is the card as ``nvidia-smi``
names it, the line before it the kernels' JSON record, and the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

FLUSH_BYTES = 256 << 20          # > the H100's 50 MB L2
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor cores, data sheet
FP32_FLOPS_PER_S = 67e12         # fp32 outside the tensor cores, data sheet


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bf16_err(got, ref, floor: float, what: str) -> float:
    """Max |got - ref|, checked against two bf16 ulps of ``ref`` plus an
    absolute ``floor``: both sides round an fp32 result to bf16, so equal
    algorithms land at most an ulp or two apart, and ``floor`` covers the
    kernels' own bf16 roundings (p before the PV product) near zero."""
    diff = (got.float() - ref.float()).abs()
    tol = ref.float().abs() * 2.0 ** -6 + floor
    check(bool((diff <= tol).all()),
          f"{what}: beyond two bf16 ulps + {floor} (max err "
          f"{diff.max().item()})")
    return diff.max().item()


def bound(flops: float, nbytes: float, peak: float = BF16_FLOPS_PER_S):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def grad_err(got, ref, what: str, floor_frac: float = 0.02,
             norm_tol: float = 1e-2) -> float:
    """Two bf16 ulps of ``ref`` plus ``floor_frac`` of its largest value
    element-wise, and ``norm_tol`` in relative norm. The backward kernels
    round p, ds (flash) and the softmax gradient tile (LM-head CE) to bf16
    before their products, as the TPU kernels do, where the plain versions
    keep fp32, and sum in other orders (fixed ones: a rerun is bitwise)."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    floor = floor_frac * ref.abs().max().item() + 1e-12
    check(bool((diff <= ref.abs() * 2.0 ** -6 + floor).all()),
          f"{what}: beyond two bf16 ulps + {floor:.3g} (max err "
          f"{diff.max().item()})")
    rel = (diff.norm() / ref.norm().clamp_min(1e-30)).item()
    check(rel <= norm_tol, f"{what}: relative norm error {rel} > {norm_tol}")
    return diff.max().item()


# cycles of ``torch.cuda._sleep`` queued before each timed launch: ~150 us
# at the H100's 1.98 GHz, more than a wrapper's 25-72 us of host time
SLEEP_CYCLES = 300_000


class Timer:
    """Median milliseconds of ``fn`` over ``iters`` launches, each timed by
    its own CUDA events after an L2 flush. Device time only: a
    ``torch.cuda._sleep`` queued after the flush and before the start event
    keeps the card busy while the host records the start event and runs
    the wrapper, so the kernel is queued before the card reaches the start
    event and the pair holds no host time."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                                 device="cuda")
        # a second of large products first, so the clocks have ramped up
        # before the first kernel is timed
        a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 1.0:
            a @ a
            torch.cuda.synchronize()

    def __call__(self, fn, iters: int = 30, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events]))


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _fwd_bound(b, h, sq, sk, d, causal, itemsize, peak=BF16_FLOPS_PER_S,
               live_rows=None):
    """The forward's bound: two products of 2 d flops per live (q, k) pair
    (causal: the end-aligned lower triangle; rows past ``live_rows`` see no
    key), q, k, v read once, out and the fp32 lse written once."""
    rows = sq if live_rows is None else live_rows
    if causal:
        off = sk - sq
        pairs = sum(max(0, min(sk, r + off + 1)) for r in range(rows))
    else:
        pairs = rows * sk
    flops = 4.0 * b * h * d * pairs
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * itemsize \
        + b * h * sq * 4
    return bound(flops, nbytes, peak)


def check_flash(torch, timer):
    """The flash forward on both routes. The wgmma route
    (``csrc/flash_fwd_sm90.cu``; bf16 and fp16 at kernel head dims 64 and
    128): the serve prefill's shape (b1 h16 s512 causal, segment ids
    padding from 300; both block heights timed), the train cells' b8 h16
    s1024 and b2 h16 s4096, ragged shapes, sq != sk, fp16 and a padded
    head dim, a bitwise rerun. flash_fwd.cu's route at the O0 path's
    shape (fp32 b8 h16 s1024) and bf16 d32."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    def wgmma_moved(w0, f0):
        return (fa.flash_attention.wgmma_launches - w0,
                fa.flash_attention.launches - f0)

    # the ragged edges: a q tile past sq, keys past sk, sq < sk, sq > sk,
    # fp16, d 80 (padded to 128), and d 32 (flash_fwd.cu's route)
    for b, h, sq, sk, d, causal, dtype, wgmma in (
            (2, 3, 77, 77, 64, True, torch.bfloat16, True),
            (1, 2, 40, 130, 128, True, torch.bfloat16, True),
            (1, 2, 300, 129, 128, True, torch.float16, True),
            (2, 2, 257, 257, 80, True, torch.bfloat16, True),
            (2, 2, 100, 100, 32, False, torch.bfloat16, False)):
        q, k, v = (rand(b, h, s_, d, dtype=dtype) for s_ in (sq, sk, sk))
        n0 = (fa.flash_attention.wgmma_launches, fa.flash_attention.launches)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        check(wgmma_moved(*n0) == (int(wgmma), 1),
              f"flash b{b} sq{sq} sk{sk} d{d} {dtype}: wrong route")
        ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
        bf16_err(out, ref, 4e-3, f"flash b{b} h{h} sq{sq} sk{sk} d{d}")
        check((lse - ref_lse).abs().max().item() <= 1e-3, "flash lse")

    # the serve prefill's shape: b1 h16 s512 causal, padding from 300
    b, h, s, d, live = 1, 16, 512, 64, 300
    q, k, v = rand(b, h, s, d), rand(b, h, s, d), rand(b, h, s, d)
    sid = torch.where(torch.arange(s, device="cuda") < live, 0, -1)
    sid = sid.to(torch.int32)[None].contiguous()
    scale = d ** -0.5
    n0 = (fa.flash_attention.wgmma_launches, fa.flash_attention.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, sid, None, True, scale)
    check(wgmma_moved(*n0) == (1, 1), "flash serve shape: not the wgmma "
          "route")
    again = fa.flash_attention_fwd(q, k, v, sid, None, True, scale)
    ref, ref_lse = fa.flash_attention_reference(
        q, k, v, causal=True, segment_ids_q=sid, scale=scale)
    torch.cuda.synchronize()
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          "flash forward: a rerun gave other bits")
    err = bf16_err(out, ref, 4e-3, "flash")
    lse_err = (lse - ref_lse).abs().max().item()
    # lse is fp32 in both: only the summation order and ex2 differ
    check(lse_err <= 1e-3, f"flash lse max err {lse_err} > 1e-3")
    check(out[:, :, live:].abs().max().item() == 0.0,
          "flash: padded rows are not exactly zero")
    rows = fa.fwd_block_rows(b * h, s, d, torch.cuda.get_device_properties(
        0).multi_processor_count)
    by_rows = {r: timer(lambda: fa._flash_fwd_cuda(
        q, k, v, sid, None, True, scale, block_rows=r)) for r in (64, 128)}
    ms = timer(lambda: fa.flash_attention_fwd(q, k, v, sid, None, True,
                                              scale))
    plain_ms = timer(lambda: fa.flash_attention_reference(
        q, k, v, causal=True, segment_ids_q=sid, scale=scale))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale))
    t_bound, by = _fwd_bound(b, h, s, s, d, True, 2, live_rows=live)

    def train_shape(tb, ts, iters=30):
        """The forward at a train cell's shape (causal, no segment ids)."""
        tq, tk, tv = (rand(tb, h, ts, d) for _ in range(3))
        tout, tlse = fa.flash_attention_fwd(tq, tk, tv, None, None, True,
                                            scale)
        tref, tref_lse = fa.flash_attention_reference(tq, tk, tv,
                                                      causal=True,
                                                      scale=scale)
        torch.cuda.synchronize()
        t_err = bf16_err(tout, tref, 4e-3, f"flash b{tb} s{ts}")
        check((tlse - tref_lse).abs().max().item() <= 1e-3,
              f"flash b{tb} s{ts} lse")
        del tout, tref, tlse, tref_lse
        tb_ms, tb_by = _fwd_bound(tb, h, ts, ts, d, True, 2)
        return dict(
            shape=f"b{tb} h{h} s{ts} d{d} causal", max_abs_err=t_err,
            ms=timer(lambda: fa.flash_attention_fwd(tq, tk, tv, None, None,
                                                    True, scale), iters),
            plain_ms=timer(lambda: fa.flash_attention_reference(
                tq, tk, tv, causal=True, scale=scale), iters=5),
            library_ms=timer(lambda: F.scaled_dot_product_attention(
                tq, tk, tv, is_causal=True, scale=scale), iters),
            bound_ms=tb_ms, bound_by=tb_by)

    wgmma = dict(
        name="flash_fwd_sm90", route="cuda",
        source="apex_tpu_torch/csrc/flash_fwd_sm90.cu",
        replaces="apex_tpu/ops/flash_attention.py:251",
        shape=f"b{b} h{h} s{s} d{d} bf16 causal, segment ids -1 from "
              f"{live}; {rows}-row blocks (fwd_block_rows)",
        max_abs_err=err, tolerance="2 bf16 ulp + 4e-3; lse 1e-3; a rerun "
                                   "bitwise",
        lse_max_abs_err=lse_err, ms=ms, plain_ms=plain_ms,
        bound_ms=t_bound, bound_by=by, library_ms=lib_ms,
        library="F.scaled_dot_product_attention(is_causal=True), no "
                "segment ids",
        ms_by_block_rows=by_rows, train_shape=train_shape(8, 1024),
        long_shape=train_shape(2, 4096, iters=10))
    del q, k, v, out, lse, again, ref, ref_lse

    # flash_fwd.cu: fp32 at the O0 path's shape (b8 h16 s1024 d64 causal)
    b, s = 8, 1024
    q, k, v = (rand(b, h, s, d, dtype=torch.float32) for _ in range(3))
    n0 = (fa.flash_attention.wgmma_launches, fa.flash_attention.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, True, scale)
    check(wgmma_moved(*n0) == (0, 1), "flash fp32: not flash_fwd.cu")
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True,
                                                scale=scale)
    torch.cuda.synchronize()
    f32_err = _fp32_err(out, ref, "flash fp32", FP32_FWD_TOL)
    check((lse - ref_lse).abs().max().item() <= 1e-3, "flash fp32 lse")
    f32_bound = _fwd_bound(b, h, s, s, d, True, 4, FP32_FLOPS_PER_S)
    simt = dict(
        name="flash_fwd", route="cuda",
        source="apex_tpu_torch/csrc/flash_fwd.cu",
        replaces="apex_tpu/ops/flash_attention.py:251",
        shape=f"b{b} h{h} s{s} d{d} fp32 causal (the O0 path's; also bf16 "
              "d32 above)",
        max_abs_err=f32_err, tolerance=f"{FP32_FWD_TOL} of max and in "
                                       "relative norm",
        ms=timer(lambda: fa.flash_attention_fwd(q, k, v, None, None, True,
                                                scale), iters=10),
        plain_ms=timer(lambda: fa.flash_attention_reference(
            q, k, v, causal=True, scale=scale), iters=5),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale), iters=10),
        library="F.scaled_dot_product_attention(is_causal=True), fp32",
        bound_ms=f32_bound[0], bound_by=f32_bound[1])
    return [wgmma, simt]


def _paged_inputs(torch, gen, b, kv, g, d, page, m, num_pages, seq_lens,
                  one_table=False):
    """bf16 q and pools; a block table with pages of their own for each row
    (from a seeded permutation), or, with ``one_table``, every row over the
    same pages (a speculative verify call: rows of one sequence)."""
    q = torch.randn(b, kv, g, d, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp = torch.randn(kv, num_pages, page, d, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    vp = torch.randn(kv, num_pages, page, d, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    rng = np.random.RandomState(2)
    pages = rng.permutation(np.arange(1, num_pages))
    bt = np.zeros((b, m), np.int32)
    used = 0
    for i, n in enumerate(seq_lens):
        need = -(-n // page)
        bt[i, :need] = pages[:need] if one_table else pages[used:used + need]
        used += 0 if one_table else need
    bt = torch.from_numpy(bt).cuda()
    sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, sl


def _fp8_pool(torch, gen, kv, num_pages, page, d):
    """An e4m3 pool quantized per (kv head, page) with the codec, as the
    fp8 cache writes it (one scale per page, 2 powers of two of headroom)."""
    from apex_tpu_torch.amp import fp8
    x = torch.randn(kv, num_pages, page, d, generator=gen, device="cuda")
    s = fp8.compute_scale(x.abs().amax(dim=(2, 3)), fp8.E4M3_MAX, 2.0)
    return fp8.quantize(x, s[..., None, None], fp8.E4M3), s


# the serve engines' decode calls: the mixed batch of the bf16 and fp8
# engines, the speculative engine's draft call (one active row in the fixed
# batch of 8) and its verify call (k + 1 = 5 rows of one sequence)
PAGED_SHAPES = (("mixed", [0, 1, 127, 128, 129, 300, 640, 1024], False),
                ("spec_draft", [300, 0, 0, 0, 0, 0, 0, 0], False),
                ("spec_verify", [300, 301, 302, 303, 304, 0, 0, 0], True))


def _paged_bound(bt, seq_lens, kv, g, d, page, item, fp8):
    """Each live K and V row read once (rows that share a page, as a verify
    call's do, once), q and out, the tables, and the fp8 scales of the live
    pages; 4 flops a live key, query row and column."""
    bt = bt.cpu().numpy()
    rows, pages = set(), set()
    for i, n in enumerate(seq_lens):
        for t in range(n):
            rows.add((int(bt[i, t // page]), t % page))
            pages.add(int(bt[i, t // page]))
    b, m = bt.shape
    nbytes = (2 * kv * d * item * len(rows) + 2 * b * kv * g * d * 2
              + b * m * 4 + b * 4 + (2 * kv * len(pages) * 4 if fp8 else 0))
    return bound(4.0 * kv * g * d * sum(seq_lens), nbytes)


def _paged_mode(torch, timer, fp8):
    """B5 at the serve engines' shapes (b8, kv16, g1, d64, page 128, m8) in
    one pool mode: each against its plain version (p and the accumulators
    fp32 on both sides: only summation order and the bf16 output rounding),
    the dead rows exact zeros, then kernel and plain timed beside the
    bound; and its device launches in one call."""
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(8 if fp8 else 3)
    kv, g, d, page, m, num_pages = 16, 1, 64, 128, 8, 72
    what = "paged fp8" if fp8 else "paged"
    shapes, launches = [], None
    for name, seq_lens, one_table in PAGED_SHAPES:
        q, kp, vp, bt, sl = _paged_inputs(torch, gen, 8, kv, g, d, page, m,
                                          num_pages, seq_lens, one_table)
        sc = {}
        if fp8:
            (kp, ks), (vp, vs) = (_fp8_pool(torch, gen, kv, num_pages, page,
                                            d) for _ in range(2))
            sc = dict(k_scales=ks, v_scales=vs)
        out = fa.paged_decode_attention(q, kp, vp, bt, sl, **sc)
        ref = fa.paged_attention_reference(q, kp, vp, bt, sl, **sc)
        torch.cuda.synchronize()
        err = bf16_err(out, ref, 1e-3, f"{what} {name}")
        for i, n in enumerate(seq_lens):
            check(n > 0 or out[i].abs().max().item() == 0.0,
                  f"{what} {name}: inactive slot {i} not zero")
        ms = timer(lambda: fa.paged_decode_attention(q, kp, vp, bt, sl,
                                                     **sc))
        plain_ms = timer(lambda: fa.paged_attention_reference(
            q, kp, vp, bt, sl, **sc))
        t_bound, by = _paged_bound(bt, seq_lens, kv, g, d, page,
                                   1 if fp8 else 2, fp8)
        shapes.append(dict(shape=name, seq_lens=seq_lens, max_abs_err=err,
                           ms=ms, plain_ms=plain_ms, bound_ms=t_bound,
                           bound_by=by))
        if launches is None:
            launches = device_launches(torch, lambda: fa.paged_decode_attention(
                q, kp, vp, bt, sl, **sc), ("paged_decode_kernel",))
            check(launches == {"paged_decode_kernel": 1, "other": 0},
                  f"{what}: device launches {launches} in one call, "
                  "expected one paged_decode_kernel and nothing else")
    return shapes, launches


def check_paged(torch, timer):
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(3)
    # GQA group 3, a dead slot, a partial page
    q, kp, vp, bt, sl = _paged_inputs(torch, gen, 3, 2, 3, 64, 16, 4, 9,
                                      [13, 0, 64])
    out = fa.paged_decode_attention(q, kp, vp, bt, sl)
    ref = fa.paged_attention_reference(q, kp, vp, bt, sl)
    bf16_err(out, ref, 1e-3, "paged GQA group 3")
    check(out[1].abs().max().item() == 0.0, "paged: dead slot not zero")
    shapes, launches = _paged_mode(torch, timer, fp8=False)
    main = shapes[0]
    return dict(name="paged_decode", route="cuda",
                source="apex_tpu_torch/csrc/paged_decode.cu",
                replaces="apex_tpu/ops/flash_attention.py:986",
                shape=f"b8 kv16 g1 d64 page128 m8 seq_lens "
                      f"{main['seq_lens']} (by_shape: the spec draft and "
                      "verify calls too)",
                max_abs_err=max(x["max_abs_err"] for x in shapes),
                tolerance="2 bf16 ulp + 1e-3", ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None, by_shape=shapes,
                device_launches_per_call=launches,
                registers=_decode_registers(_build, "paged_decode"))


def check_paged_fp8(torch, timer):
    shapes, launches = _paged_mode(torch, timer, fp8=True)
    main = shapes[0]
    return dict(name="paged_decode_fp8", route="cuda",
                source="apex_tpu_torch/csrc/paged_decode.cu",
                replaces="apex_tpu/ops/flash_attention.py:986",
                shape=f"b8 kv16 g1 d64 page128 m8 e4m3 pool, [kv, pages] "
                      f"fp32 scales, seq_lens {main['seq_lens']} (by_shape: "
                      "the spec draft and verify calls too)",
                max_abs_err=max(x["max_abs_err"] for x in shapes),
                tolerance="2 bf16 ulp + 1e-3", ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None, by_shape=shapes,
                device_launches_per_call=launches)


# the block linears of the 12-layer h1024 GPT, [in, out]
FP8_SHAPES = (("qkv", 1024, 3072), ("proj", 1024, 1024), ("fc1", 1024, 4096),
              ("fc2", 4096, 1024))


def check_fp8_matmul(torch, timer):
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import fp8_matmul as mm
    gen = torch.Generator(device="cuda").manual_seed(9)
    shapes, launches = [], None
    # decode (m = 8, the fixed batch) at the four linears, prefill (m = 512,
    # one padded prompt) at fc1, then decode qkv once more: the spread of
    # the same measurement within one run
    plan = ([(8, s) for s in FP8_SHAPES] + [(512, FP8_SHAPES[2]),
                                            (8, FP8_SHAPES[0])])
    for m, (lin, K, N) in plan:
        x = torch.randn(m, K, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        w = torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5
        q, scale = mm.quantize_weight(w)
        y = mm.fp8_dequant_matmul(x, q, scale)
        ref = mm.fp8_dequant_matmul_reference(x, q, scale)
        torch.cuda.synchronize()
        # exact operands (every e4m3 value and the bf16 x are exact in
        # fp32), fp32 sums in another order, one bf16 rounding of each
        # side; the floor covers outputs near zero (|y| ~ 1 here)
        err = bf16_err(y, ref, 1e-3, f"fp8_matmul {lin} m{m}")
        wb = w.to(torch.bfloat16)
        ms = timer(lambda: mm.fp8_dequant_matmul(x, q, scale))
        plain_ms = timer(lambda: mm.fp8_dequant_matmul_reference(x, q,
                                                                 scale))
        bf16_ms = timer(lambda: torch.matmul(x, wb))
        nbytes = K * N + m * K * 2 + m * N * 2 + 4
        t_bound, by = bound(2.0 * m * K * N, nbytes)
        shapes.append(dict(linear=lin, m=m, K=K, N=N, max_abs_err=err,
                           ms=ms, plain_ms=plain_ms, bound_ms=t_bound,
                           bound_by=by, bf16_matmul_ms=bf16_ms))
        if launches is None:           # the decode regime: one launch a call
            launches = device_launches(torch, lambda: mm.fp8_dequant_matmul(
                x, q, scale), ("fp8_mm_decode_kernel",))
            check(launches == {"fp8_mm_decode_kernel": 1, "other": 0},
                  f"fp8_matmul m{m}: device launches {launches} in one "
                  "call, expected one fp8_mm_decode_kernel and nothing else")
    main = shapes[0]                       # decode qkv
    return dict(name="fp8_matmul", route="cuda",
                source="apex_tpu_torch/csrc/fp8_matmul.cu",
                replaces="apex_tpu/ops/fp8_matmul.py:76",
                shape="m8 K1024 N3072 (decode qkv): bf16 x, e4m3 [K, N] "
                      "weight, fp32 device scale (by_shape: the four decode "
                      "linears and prefill fc1 at m512)",
                max_abs_err=max(s["max_abs_err"] for s in shapes),
                tolerance="2 bf16 ulp + 1e-3", ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None,
                library="none computes it in one call; bf16_matmul_ms is "
                        "torch.matmul on the unquantized bf16 weight, what "
                        "fp8 streaming competes with",
                bf16_matmul_ms=main["bf16_matmul_ms"],
                ms_repeat=shapes[-1]["ms"], by_shape=shapes,
                device_launches_per_call=launches,
                registers=_decode_registers(_build, "fp8_matmul"))


def check_e4m3_cast(torch):
    """The codec's quantize on the card against the CPU's, bitwise: fp32
    values over every e4m3 binade, the subnormals and past the maximum."""
    from apex_tpu_torch.amp import fp8
    gen = torch.Generator(device="cuda").manual_seed(10)
    n = 1 << 20
    x = torch.randn(n, generator=gen, device="cuda") * torch.exp2(
        torch.randint(-14, 12, (n,), generator=gen, device="cuda").float())
    for s in (1.0, 0.37, 12.5, 3e-3):
        sc = torch.tensor(s, device="cuda")
        got = fp8.quantize(x, sc, fp8.E4M3).view(torch.uint8).cpu()
        want = fp8.quantize(x.cpu(), sc.cpu(), fp8.E4M3).view(torch.uint8)
        bad = int((got != want).sum())
        check(bad == 0, f"e4m3 cast: {bad} of {n} bytes differ from the "
              f"CPU's at scale {s}")
    amax = x.abs().amax()
    for margin in (0.0, 2.0):
        a = fp8.compute_scale(amax, fp8.E4M3_MAX, margin).cpu()
        b = fp8.compute_scale(amax.cpu(), fp8.E4M3_MAX, margin)
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              "compute_scale on the card differs from the CPU's")
    return dict(values=n, scales=4, bitwise_equal=True)


def check_layer_norm(torch, timer):
    import torch.nn.functional as F
    from apex_tpu_torch.ops import layer_norm as ln
    gen = torch.Generator(device="cuda").manual_seed(4)
    h = 1024
    w = 1 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    bb = 0.1 * torch.randn(h, generator=gen, device="cuda")
    shapes = []
    # decode (n8) and prefill (n512) with fp32 params; the O2 train path
    # (n8192) with the bf16 params amp's cast gives it
    for n, p_dtype in ((8, torch.float32), (512, torch.float32),
                       (8192, torch.bfloat16)):
        w, bb = w.to(p_dtype), bb.to(p_dtype)
        x = torch.randn(n, h, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        y = ln.fused_layer_norm_affine(x, w, bb, (h,), 1e-5, torch.bfloat16)
        ref = ln.fused_layer_norm_affine_reference(x, w, bb, (h,), 1e-5,
                                                   torch.bfloat16)
        torch.cuda.synchronize()
        diff = (y.float() - ref.float()).abs()
        err = diff.max().item()
        # both round fp32 results to bf16: at most one bf16 ulp apart
        ulp = ref.float().abs() * 2.0 ** -7 + 1e-6
        check(bool((diff <= ulp).all()), f"LN n{n}: beyond one bf16 ulp")
        ms = timer(lambda: ln.fused_layer_norm_affine(x, w, bb, (h,), 1e-5,
                                                      torch.bfloat16))
        plain_ms = timer(lambda: ln.fused_layer_norm_affine_reference(
            x, w, bb, (h,), 1e-5, torch.bfloat16))
        wb, bbb = w.to(torch.bfloat16), bb.to(torch.bfloat16)
        lib_ms = timer(lambda: F.layer_norm(x, (h,), wb, bbb, 1e-5))
        nbytes = 2 * n * h * 2 + 2 * h * w.element_size()
        t_bound, by = bound(10.0 * n * h, nbytes)
        shapes.append(dict(n=n, h=h, params=str(p_dtype), max_abs_err=err,
                           ms=ms,
                           plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                           library_ms=lib_ms))
    main = shapes[1]                       # the prefill shape, n = 512
    return dict(name="layer_norm_fwd", route="triton",
                source="apex_tpu_torch/ops/layer_norm.py",
                replaces="apex_tpu/ops/layer_norm.py:131",
                shape=f"n512 h{h} bf16 in/out, fp32 params (by_shape: n8, "
                      "and n8192 with bf16 params as on the train path)",
                max_abs_err=max(s["max_abs_err"] for s in shapes),
                tolerance="one bf16 ulp", ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"],
                library="F.layer_norm with bf16 weight/bias",
                by_shape=shapes)


def _grad_of(torch, fn, inputs, dout):
    """A closure timing the autograd backward of ``fn(*inputs)`` (the
    forward runs once, outside the timed call)."""
    ins = [t.detach().requires_grad_() for t in inputs]
    out = fn(*ins)
    return lambda: torch.autograd.grad(out, ins, dout, retain_graph=True)


def _bwd_bound(b, h, s, d, itemsize, peak=BF16_FLOPS_PER_S):
    """The single pass's bound at a causal self-attention shape: five
    products of 2 d flops per live pair (s, dp, dv, dk, dq); q, k, v, out,
    do read and dq, dk, dv written once, lse and delta read once (fp32)."""
    pairs = s * (s + 1) // 2
    return bound(5 * 2.0 * b * h * d * pairs,
                 8 * b * h * s * d * itemsize + 2 * b * h * s * 4, peak)


def check_flash_bwd(torch, timer):
    """The single-pass backward on both routes. The wgmma route
    (``flash_bwd_fused_sm90`` of ``csrc/flash_bwd_sm90.cu``) at the train
    cell's b8 h16 s1024 d64 causal: as called (the delta pass, the zeroing
    of dq_acc and its turn counters, and the cast included) and alone on a
    given delta and dq_acc, beside the split forced at the same shape and
    SDPA's backward; dq, dk and dv bitwise on a rerun and, for the first
    batch, bitwise the same run alone (dq is summed in a fixed order of
    key blocks); segment ids with padding rows, whose dq is exactly zero
    (ptxas's registers and spills: check_flash_split). flash_bwd.cu's
    single pass at the O0 path's shape (fp32), dq, dk and dv bitwise on a
    rerun and for the first batch alone."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(5)
    f = fa.flash_attention_bwd

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    def moved(n0):
        return (f.wgmma_launches - n0[0], f.launches - n0[1])

    # segment ids with padding rows, at the training width
    b, h, s, d, live = 2, 16, 1024, 64, 700
    q, k, v, do = (rand(b, h, s, d) for _ in range(4))
    sid = torch.where(torch.arange(s, device="cuda") < live, 0, -1)
    sid = sid.to(torch.int32)[None].expand(b, s).contiguous()
    out, lse = fa.flash_attention_fwd(q, k, v, sid, None, True)
    n0 = (f.wgmma_launches, f.launches)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, sid, None,
                                        True)
    check(moved(n0) == (1, 1), "flash_bwd segments: not the wgmma route")
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=True, segment_ids_q=sid)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        grad_err(g, r, f"flash_bwd segments {name}")
    check(dq[:, :, live:].abs().max().item() == 0.0,
          "flash_bwd: padding rows got a nonzero dq")

    # the training path's shape: b8 h16 s1024 d64 causal
    b = 8
    q, k, v, do = (rand(b, h, s, d) for _ in range(4))
    scale = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, True, scale)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                 scale)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                   scale)
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=True, scale=scale)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
          "flash_bwd: dq, dk or dv changed on a rerun")
    _check_first_batch_alone(torch, fa, got, q, k, v, out, lse, do, scale,
                             "flash_bwd")
    err = max(grad_err(g, r, f"flash_bwd {n}")
              for n, g, r in zip(("dq", "dk", "dv"), got, ref))
    del got, again, ref
    delta = (do.float() * out.float()).sum(dim=-1)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    alone_ms = timer(lambda: fa._flash_bwd_fused_cuda(
        q, k, v, do, lse, delta, None, None, True, scale, dq_acc))
    ms = timer(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, None,
                                              None, True, scale))
    split_ms = timer(lambda: fa._flash_bwd_cuda(
        q, k, v, out, lse, do, None, None, True, scale, split=True))
    plain_ms = timer(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=True, scale=scale), iters=10)
    lib_ms = timer(_grad_of(torch, lambda a, b_, c: (
        F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                       scale=scale)), (q, k, v), do))
    t_bound, by = _bwd_bound(b, h, s, d, 2)
    wgmma = dict(
        name="flash_bwd_fused_sm90", route="cuda",
        source="apex_tpu_torch/csrc/flash_bwd_sm90.cu",
        replaces="apex_tpu/ops/flash_attention.py:604",
        shape=f"b{b} h{h} s{s} d{d} bf16 causal (also b2 with segment ids, "
              f"padding from {live})",
        max_abs_err=err,
        tolerance="2 bf16 ulp + 2% of max, 1% relative norm; dq, dk, dv "
                  "bitwise on a rerun and for one batch alone",
        ms=alone_ms, as_called_ms=ms, split_ms=split_ms, plain_ms=plain_ms,
        bound_ms=t_bound, bound_by=by, library_ms=lib_ms,
        library="backward of F.scaled_dot_product_attention("
                "is_causal=True)")
    del q, k, v, do, out, lse, delta, dq_acc

    # flash_bwd.cu: fp32 at the O0 path's shape
    q, k, v, do = (rand(b, h, s, d, dtype=torch.float32) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, True, scale)
    n0 = (f.wgmma_launches, f.launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                 scale)
    check(moved(n0) == (0, 1), "flash_bwd fp32: not flash_bwd.cu")
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                   scale)
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=True, scale=scale)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
          "flash_bwd fp32: dq, dk or dv changed on a rerun")
    _check_first_batch_alone(torch, fa, got, q, k, v, out, lse, do, scale,
                             "flash_bwd fp32")
    f32_err = max(_fp32_err(g, r, f"flash_bwd fp32 {n}", FP32_GRAD_TOL)
                  for n, g, r in zip(("dq", "dk", "dv"), got, ref))
    del got, again, ref
    f32_bound = _bwd_bound(b, h, s, d, 4, FP32_FLOPS_PER_S)
    simt = dict(
        name="flash_bwd", route="cuda",
        source="apex_tpu_torch/csrc/flash_bwd.cu",
        replaces="apex_tpu/ops/flash_attention.py:604",
        shape=f"b{b} h{h} s{s} d{d} fp32 causal (the O0 path's)",
        max_abs_err=f32_err,
        tolerance=f"{FP32_GRAD_TOL} of max and in relative norm; dq, dk, "
                  "dv bitwise on a rerun and for one batch alone",
        ms=timer(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, None,
                                                None, True, scale), iters=5),
        plain_ms=timer(lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=True, scale=scale), iters=5),
        library_ms=timer(_grad_of(torch, lambda a, b_, c: (
            F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                           scale=scale)), (q, k, v), do),
            iters=5),
        library="backward of F.scaled_dot_product_attention("
                "is_causal=True), fp32",
        bound_ms=f32_bound[0], bound_by=f32_bound[1])
    return [wgmma, simt]


def _check_first_batch_alone(torch, fa, got, q, k, v, out, lse, do, scale,
                             what):
    """The single pass's gradients of the first batch, run alone, are the
    same bits as in the full batch's run: each query tile's dq is summed in
    an order of its own key blocks, whatever else shares the grid."""
    one = fa.flash_attention_bwd(q[:1], k[:1], v[:1], out[:1], lse[:1],
                                 do[:1], None, None, True, scale)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b_[:1]) for a, b_ in zip(one, got)),
          f"{what}: the first batch's gradients differ run alone")


def check_layer_norm_bwd(torch, timer):
    import torch.nn.functional as F
    from apex_tpu_torch.ops import layer_norm as ln
    gen = torch.Generator(device="cuda").manual_seed(6)
    n, h = 8192, 1024
    x = torch.randn(n, h, generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn(n, h, generator=gen, device="cuda").to(torch.bfloat16)
    errs = []
    for p_dtype in (torch.float32, torch.bfloat16):
        w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(
            p_dtype)
        got = ln.layer_norm_bwd(x, w, dy, (h,), 1e-5, p_dtype)
        ref = ln.layer_norm_bwd_reference(x, w, dy, (h,), 1e-5, p_dtype)
        torch.cuda.synchronize()
        # dx: fp32 math on both sides, one rounding to bf16 (one ulp);
        # dgamma/dbeta: fp32 sums over 8192 rows in another order
        d = (got[0].float() - ref[0].float()).abs()
        check(bool((d <= ref[0].float().abs() * 2.0 ** -7 + 1e-6).all()),
              f"LN bwd dx beyond one bf16 ulp (max err {d.max().item()})")
        for name, g, r in zip(("dw", "db"), got[1:], ref[1:]):
            ulp = 2.0 ** -7 if p_dtype == torch.bfloat16 else 0.0
            d = (g.float() - r.float()).abs()
            tol = r.float().abs() * ulp + 1e-4 * r.float().abs().max().item()
            check(bool((d <= tol).all()),
                  f"LN bwd {name} ({p_dtype}) max err {d.max().item()}")
        errs.append(max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(got, ref)))
    # w is the bf16 weight of the O2 main path from here on
    b_ = torch.zeros(h, device="cuda", dtype=torch.bfloat16)
    ms = timer(lambda: ln.layer_norm_bwd(x, w, dy, (h,), 1e-5))
    plain_ms = timer(lambda: ln.layer_norm_bwd_reference(x, w, dy, (h,),
                                                         1e-5))
    lib_ms = timer(_grad_of(torch, lambda a, ww, bb: F.layer_norm(
        a, (h,), ww, bb, 1e-5), (x, w, b_), dy))
    nbytes = 3 * n * h * 2 + 3 * h * 2
    t_bound, by = bound(20.0 * n * h, nbytes)
    return dict(name="layer_norm_bwd", route="triton",
                source="apex_tpu_torch/ops/layer_norm.py",
                replaces="apex_tpu/ops/layer_norm.py:141",
                shape=f"n{n} h{h} bf16 x/dy, bf16 params (and fp32 params)",
                max_abs_err=max(errs),
                tolerance="dx one bf16 ulp; dgamma/dbeta one ulp + 1e-4 of "
                          "max",
                ms=ms, plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                library_ms=lib_ms,
                library="backward of F.layer_norm (bf16 w/b)")


CE_PRODUCTS = ("GradEpi", "DxEpi", "DeEpi")   # B9's three epilogues


def device_launches(torch, fn, names):
    """torch.profiler over one call of ``fn`` (after one unprofiled): the
    device kernels it launched, counted by which of ``names`` their name
    holds (each kernel must hold at most one), ``other`` for the rest."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(tuple(names) + ("other",), 0)
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        hit = [p for p in names if p in ev.key]
        counts[hit[0] if len(hit) == 1 else "other"] += ev.count
    return counts


def check_lm_head_ce(torch, timer):
    """B8 and B9, the wgmma/TMA kernels of ``csrc/lm_head_ce_sm90.cu``, at
    the GPT step's n 8192, V 32768, h 1024 in bf16: against the plain
    versions (label smoothing 0 and 0.1), the backward's dx and dE bitwise
    on a second run, its device launches counted by the profiler (three
    products a token chunk and nothing else), then kernel, plain and
    library timed."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import lm_head_ce as ce
    gen = torch.Generator(device="cuda").manual_seed(7)
    n, V, h = 8192, 32768, 1024
    x = torch.randn(n, h, generator=gen, device="cuda").to(torch.bfloat16)
    e = (0.02 * torch.randn(V, h, generator=gen, device="cuda")).to(
        torch.bfloat16)
    tgt = torch.randint(0, V, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    dl = torch.full((n,), 1.0 / n, device="cuda")
    fwd_err, bwd_err = 0.0, 0.0
    for ls in (0.0, 0.1):
        got = ce.lm_head_ce_fwd(x, e, tgt, ls > 0)
        ref = ce.lm_head_ce_fwd_reference(x, e, tgt, ls > 0)
        torch.cuda.synchronize()
        # fp32 sums of the same exact products in another order
        for name, a, r in zip(("m", "l", "pred", "ssum"), got, ref):
            if r is None:
                continue
            err = (a - r).abs().max().item()
            check(err <= 1e-4 * (r.abs().max().item() + 1.0),
                  f"CE fwd {name} (ls {ls}) max err {err}")
            fwd_err = max(fwd_err, err)
        m, l = ref[0], ref[1]
        dx, de = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl, ls)
        rx, re = ce.lm_head_ce_bwd_reference(x, e, tgt, m, l, dl, ls)
        torch.cuda.synchronize()
        bwd_err = max(bwd_err, grad_err(dx, rx, f"CE bwd dx (ls {ls})"),
                      grad_err(de, re, f"CE bwd dE (ls {ls})"))
        dx2, de2 = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl, ls)
        check(torch.equal(dx, dx2) and torch.equal(de, de2),
              f"CE bwd (ls {ls}): two runs differ (no atomics: they must "
              "not)")
        del got, ref, dx, de, rx, re, dx2, de2
    m, l, _, _ = ce.lm_head_ce_fwd_reference(x, e, tgt)
    chunks = -(-n // ce.bwd_chunk_tokens(n, V))
    # B9's launches, by the wgmma core's epilogue they carry
    # (``gemm_kernel<GradEpi<...>>`` and so on)
    products = device_launches(torch, lambda: ce.lm_head_ce_bwd(
        x, e, tgt, m, l, dl), CE_PRODUCTS)
    check(products == {**dict.fromkeys(CE_PRODUCTS, chunks), "other": 0},
          f"CE bwd: device launches {products} in one call, expected each "
          f"of {CE_PRODUCTS} once a chunk ({chunks} chunks) and no other")
    fwd_ms = timer(lambda: ce.lm_head_ce_fwd(x, e, tgt), iters=10)
    fwd_plain = timer(lambda: ce.lm_head_ce_fwd_reference(x, e, tgt),
                      iters=10)
    fwd_lib = timer(lambda: F.cross_entropy(F.linear(x, e).float(),
                                            tgt.long()), iters=10)
    bwd_ms = timer(lambda: ce.lm_head_ce_bwd(x, e, tgt, m, l, dl), iters=10)
    bwd_plain = timer(lambda: ce.lm_head_ce_bwd_reference(
        x, e, tgt, m, l, dl), iters=5)
    bwd_lib = timer(_grad_of(torch, lambda a, w: F.cross_entropy(
        F.linear(a, w).float(), tgt.long()), (x, e),
        torch.ones((), device="cuda")), iters=10)
    prod = 2.0 * n * V * h
    io = n * h * 2 + V * h * 2 + n * 4
    fb, fby = bound(prod, io + 4 * n * 4)
    bb, bby = bound(3 * prod, io + 3 * n * 4 + V * h * 2 + n * h * 2)
    common = dict(route="cuda",
                  source="apex_tpu_torch/csrc/lm_head_ce_sm90.cu",
                  shape=f"n{n} V{V} h{h} bf16 x/E, int32 targets; label "
                        "smoothing 0 and 0.1 checked")
    return [
        dict(name="lm_head_ce_fwd", replaces="apex_tpu/ops/lm_head_ce.py:162",
             max_abs_err=fwd_err, tolerance="1e-4 of max (fp32 stats)",
             ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fb, bound_by=fby,
             library_ms=fwd_lib,
             library="two calls: F.linear then F.cross_entropy on fp32 "
                     "logits", **common),
        dict(name="lm_head_ce_bwd", replaces="apex_tpu/ops/lm_head_ce.py:198",
             max_abs_err=bwd_err,
             tolerance="2 bf16 ulp + 2% of max, 1% relative norm",
             ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bb, bound_by=bby,
             library_ms=bwd_lib,
             library="autograd backward of F.linear + F.cross_entropy",
             device_launches_per_call=products, **common),
    ]


# B8 and B9's fp32 kernels (csrc/lm_head_ce.cu) by name
CE32_KERNELS = ("ce32_transpose_kernel", "ce32_fwd_kernel",
                "ce32_grad_kernel", "ce32_product_kernel")


def _ce32_registers(build):
    """``ptxas -v``'s registers and spill bytes of each fp32 CE kernel;
    fails on a spill."""
    regs, name = {}, None
    log_text = build.library_path(build.dtype_target("lm_head_ce", 2)) \
        .with_suffix(".log").read_text()
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((k for k in CE32_KERNELS if k in m.group(1)), None)
            if name:
                regs[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            regs[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            check(regs[name]["spill_bytes"] == 0,
                  f"lm_head_ce@f32 {name}: ptxas spills "
                  f"{regs[name]['spill_bytes']} bytes")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name]["registers"] = int(m.group(1))
    check(set(regs) == set(CE32_KERNELS),
          f"lm_head_ce@f32: kernels in ptxas's log {sorted(regs)}")
    return regs


def check_lm_head_ce_f32(torch, timer):
    """B8 and B9's fp32 route (``csrc/lm_head_ce.cu`` on the FFMA core of
    ``csrc/simt_f32.cuh``) at the O0 path's n 8192, V 32768, h 1024:
    against the plain versions (label smoothing 0 and 0.1; the statistics
    within 1e-4 of the largest, the gradients FP32_GRAD_TOL), dx and dE
    bitwise on a second run, the device launches of one call counted by
    the profiler (the forward: two transposes and one product kernel; the
    backward: two transposes, then a logits kernel and two products a
    token chunk, and nothing else), ptxas's registers with no spill; then
    kernel, plain and library timed, the library in exact fp32 (TF32 off,
    float32 matmul precision "highest", both recorded)."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import lm_head_ce as ce
    gen = torch.Generator(device="cuda").manual_seed(8)
    n, V, h = 8192, 32768, 1024
    x = torch.randn(n, h, generator=gen, device="cuda")
    e = 0.02 * torch.randn(V, h, generator=gen, device="cuda")
    tgt = torch.randint(0, V, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    dl = torch.full((n,), 1.0 / n, device="cuda")
    fwd_err, bwd_err = 0.0, 0.0
    for ls in (0.0, 0.1):
        n0 = (ce.lm_head_ce_fwd.f32_launches, ce.lm_head_ce_bwd.f32_launches)
        got = ce.lm_head_ce_fwd(x, e, tgt, ls > 0)
        ref = ce.lm_head_ce_fwd_reference(x, e, tgt, ls > 0)
        torch.cuda.synchronize()
        # fp32 sums of the same exact products in another order
        for name, a, r in zip(("m", "l", "pred", "ssum"), got, ref):
            if r is None:
                continue
            err = (a - r).abs().max().item()
            check(err <= 1e-4 * (r.abs().max().item() + 1.0),
                  f"CE fp32 fwd {name} (ls {ls}) max err {err}")
            fwd_err = max(fwd_err, err)
        m, l = ref[0], ref[1]
        dx, de = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl, ls)
        rx, re_ = ce.lm_head_ce_bwd_reference(x, e, tgt, m, l, dl, ls)
        dx2, de2 = ce.lm_head_ce_bwd(x, e, tgt, m, l, dl, ls)
        torch.cuda.synchronize()
        bwd_err = max(bwd_err,
                      _fp32_err(dx, rx, f"CE fp32 dx (ls {ls})",
                                FP32_GRAD_TOL),
                      _fp32_err(de, re_, f"CE fp32 dE (ls {ls})",
                                FP32_GRAD_TOL))
        check(torch.equal(dx, dx2) and torch.equal(de, de2),
              f"CE fp32 bwd (ls {ls}): two runs differ")
        check((ce.lm_head_ce_fwd.f32_launches - n0[0],
               ce.lm_head_ce_bwd.f32_launches - n0[1]) == (1, 2),
              "CE fp32: not the fp32 route")
        del got, ref, dx, de, rx, re_, dx2, de2
    m, l, _, _ = ce.lm_head_ce_fwd_reference(x, e, tgt)
    chunks = -(-n // ce.f32_chunk_tokens(n, V))
    fwd_dev = device_launches(torch, lambda: ce.lm_head_ce_fwd(x, e, tgt),
                              CE32_KERNELS)
    check({k: fwd_dev[k] for k in CE32_KERNELS} == {
        "ce32_transpose_kernel": 2, "ce32_fwd_kernel": 1,
        "ce32_grad_kernel": 0, "ce32_product_kernel": 0},
        f"CE fp32 fwd: device launches {fwd_dev} in one call")
    bwd_dev = device_launches(torch, lambda: ce.lm_head_ce_bwd(
        x, e, tgt, m, l, dl), CE32_KERNELS)
    check(bwd_dev == {"ce32_transpose_kernel": 2, "ce32_fwd_kernel": 0,
                      "ce32_grad_kernel": chunks,
                      "ce32_product_kernel": 2 * chunks, "other": 0},
          f"CE fp32 bwd: device launches {bwd_dev} in one call, expected "
          f"two transposes, then a logits kernel and two products a chunk "
          f"({chunks} chunks), and no other")
    fwd_ms = timer(lambda: ce.lm_head_ce_fwd(x, e, tgt), iters=10)
    fwd_plain = timer(lambda: ce.lm_head_ce_fwd_reference(x, e, tgt),
                      iters=5)
    fwd_lib = timer(lambda: F.cross_entropy(F.linear(x, e), tgt.long()),
                    iters=10)
    bwd_ms = timer(lambda: ce.lm_head_ce_bwd(x, e, tgt, m, l, dl), iters=5)
    bwd_plain = timer(lambda: ce.lm_head_ce_bwd_reference(
        x, e, tgt, m, l, dl), iters=3, warmup=1)
    bwd_lib = timer(_grad_of(torch, lambda a, w: F.cross_entropy(
        F.linear(a, w), tgt.long()), (x, e), torch.ones((), device="cuda")),
        iters=5)
    prod = 2.0 * n * V * h
    io = n * h * 4 + V * h * 4 + n * 4
    fb, fby = bound(prod, io + 4 * n * 4, FP32_FLOPS_PER_S)
    bb, bby = bound(3 * prod, io + 3 * n * 4 + V * h * 4 + n * h * 4,
                    FP32_FLOPS_PER_S)
    fp32_matmul = dict(allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                       precision=torch.get_float32_matmul_precision())
    common = dict(route="cuda", source="apex_tpu_torch/csrc/lm_head_ce.cu",
                  shape=f"n{n} V{V} h{h} fp32 x/E, int32 targets (the O0 "
                        "path's); label smoothing 0 and 0.1 checked",
                  fp32_matmul=fp32_matmul, registers=_ce32_registers(_build))
    return [
        dict(name="lm_head_ce_fwd_f32",
             replaces="apex_tpu/ops/lm_head_ce.py:162", max_abs_err=fwd_err,
             tolerance="1e-4 of max (fp32 stats)", ms=fwd_ms,
             plain_ms=fwd_plain, bound_ms=fb, bound_by=fby,
             library_ms=fwd_lib, tflops=prod / fwd_ms / 1e9,
             library="F.cross_entropy(F.linear(x, e), t), exact fp32",
             device_launches_per_call=fwd_dev, **common),
        dict(name="lm_head_ce_bwd_f32",
             replaces="apex_tpu/ops/lm_head_ce.py:198", max_abs_err=bwd_err,
             tolerance=f"{FP32_GRAD_TOL} of max and in relative norm; dx, "
                       "dE bitwise on a rerun",
             ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bb, bound_by=bby,
             library_ms=bwd_lib, tflops=3 * prod / bwd_ms / 1e9,
             library="autograd backward of F.linear + F.cross_entropy, "
                     "exact fp32",
             device_launches_per_call=bwd_dev, **common),
    ]


SPLIT_B, SPLIT_H, SPLIT_S, SPLIT_D = 2, 16, 4096, 64


def _split_counts(fa):
    f = fa.flash_attention_bwd
    return (f.launches, f.dkdv_launches, f.dq_launches,
            f.wgmma_dkdv_launches, f.wgmma_dq_launches)


def _split_moved(fa, before, wgmma: bool):
    """The split ran once on the named route and the single pass not."""
    moved = tuple(a - b for a, b in zip(_split_counts(fa), before))
    return moved == ((0, 1, 1, 1, 1) if wgmma else (0, 1, 1, 0, 0))


# the wgmma flash kernels in ptxas's log: the split's two, the forward (its
# second parameter the rows a block: 1 or 2 consumer warpgroups) and the
# single pass
_SM90_KERNEL = re.compile(r"(flash_dkdv_sm90|flash_dq_sm90|flash_fwd_sm90|"
                          r"flash_bwd_fused_sm90)I\d+\w+?Li(\d+)E(?:Li(\d+)E)?")
# the kernels held to no spill (the split's dk/dv kernel at d 64 spills 8
# bytes: ROADMAP §C)
_NO_SPILL = ("flash_fwd_sm90", "flash_bwd_fused_sm90")


def _sm90_registers(build):
    """``ptxas -v``'s register count and spill bytes of each kernel in the
    wgmma flash libraries (before ``setmaxnreg``: the producer warpgroup
    gives up to 40 a thread and the consumer warpgroups take 232); fails
    on a spill in this slice's kernels."""
    regs = {}
    for target in build.targets(["flash_fwd_sm90", "flash_bwd_sm90"]):
        name = None
        for line in build.library_path(target).with_suffix(".log") \
                .read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:     # e.g. ...15flash_dkdv_sm90I13__nv_bfloat16Li64EE...
                k = _SM90_KERNEL.search(m.group(1))
                name = None
                if k:
                    name = f"{target} {k.group(1)} d{k.group(2)}"
                    if k.group(3):
                        name += f" rows{64 * int(k.group(3))}"
                    regs[name] = {}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                spill = int(m.group(1)) + int(m.group(2))
                regs[name]["spill_bytes"] = spill
                check(spill == 0 or not name.split()[1] in _NO_SPILL,
                      f"{name}: ptxas spills {spill} bytes")
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                regs[name]["registers"] = int(m.group(1))
    return regs


# the decode kernels in ptxas's log: B12's decode regime (one kernel) and
# every instantiation of B5 (q dtype, head dim, rows a block, e4m3 pool,
# general path)
_DECODE_KERNEL = re.compile(
    r"(fp8_mm_decode_kernel)|paged_decode_kernelI(13__nv_bfloat16|6__half|f)"
    r"Li(\d+)ELi(\d+)ELb([01])ELb([01])E")
_DTYPE_NAMES = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}


def _decode_registers(build, source):
    """``ptxas -v``'s registers and spill bytes of each kernel of the decode
    library ``source`` (``fp8_matmul`` or ``paged_decode``, every dtype
    target); fails on any spill in them."""
    regs = {}
    for target in build.targets([source]):
        name = None
        for line in build.library_path(target).with_suffix(".log") \
                .read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = _DECODE_KERNEL.search(m.group(1))
                name = None
                if k and k.group(1):
                    name = k.group(1)
                elif k:
                    name = (f"paged_decode_kernel {_DTYPE_NAMES[k.group(2)]} "
                            f"d{k.group(3)} g{k.group(4)}"
                            + (" e4m3" if k.group(5) == "1" else "")
                            + (" general" if k.group(6) == "1" else ""))
                if name:
                    regs[name] = {}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                spill = int(m.group(1)) + int(m.group(2))
                regs[name]["spill_bytes"] = spill
                check(spill == 0, f"{target} {name}: ptxas spills {spill} "
                      "bytes")
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                regs[name]["registers"] = int(m.group(1))
    check(len(regs) > 0, f"{source}: no decode kernel in ptxas's log")
    return regs


def check_flash_split(torch, timer):
    """The two-kernel backward (dq, then dk/dv on the wgmma route; dk/dv,
    then dq on flash_bwd.cu's) at the long-sequence GPT's attention shape,
    b2 h16 s4096 d64 causal, where the JAX package's gate sends it. The
    wgmma route (bf16): each kernel against its plain version (dq and the
    delta it folds in; dk and dv from that delta), the pair against the
    plain backward, a bitwise rerun, a ragged shape with padding segment
    ids; each kernel timed apart, the pair beside the single-pass
    backward forced at the same shape, and beside B2 at b8 h16 s1024.
    flash_bwd.cu's route at the O0 long path's shape (fp32): against the
    plain backward, timed."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(11)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    # past the gate with segment ids: padding rows get zero dq
    b, h, s, d, live = 1, 4, 2304, 64, 2000
    q, k, v, do = (rand(b, h, s, d) for _ in range(4))
    sid = torch.where(torch.arange(s, device="cuda") < live, 0, -1)
    sid = sid.to(torch.int32)[None].contiguous()
    check(fa.uses_split_backward(s, s, d, 2, 2, True), "gate at s2304")
    out, lse = fa.flash_attention_fwd(q, k, v, sid, None, True)
    n0 = _split_counts(fa)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, sid, None, True)
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=True, segment_ids_q=sid)
    torch.cuda.synchronize()
    check(_split_moved(fa, n0, True),
          "s2304 did not take the split's wgmma route")
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        grad_err(g, r, f"flash split segments {name}")
    check(got[0][:, :, live:].abs().max().item() == 0.0,
          "flash split: padding rows got a nonzero dq")
    del q, k, v, do, out, lse, got, ref

    b, h, s, d = SPLIT_B, SPLIT_H, SPLIT_S, SPLIT_D
    q, k, v, do = (rand(b, h, s, d) for _ in range(4))
    scale = d ** -0.5
    check(fa.uses_split_backward(s, s, d, 2, 2, True), "gate at s4096")
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, True, scale)
    n0 = _split_counts(fa)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                 scale)
    torch.cuda.synchronize()
    check(_split_moved(fa, n0, True),
          "s4096 did not route to the split's wgmma route")
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                   scale)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          "flash split: a rerun gave other bits")
    del again
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=True, scale=scale)
    torch.cuda.synchronize()
    errs = {n: grad_err(g, r, f"flash split {n}")
            for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
    single = fa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, True,
                                scale, split=False)
    torch.cuda.synchronize()
    single_err = max(grad_err(g, r, f"flash single pass s{s} {n}")
                     for n, g, r in zip(("dq", "dk", "dv"), single, ref))
    del got, ref, single
    # each kernel against its plain version: dq (with the delta it folds
    # in: fp32 sums of the same exact products, 1e-5 of the largest) and
    # dk/dv from that delta
    rounds = fa._mixed_rounds(q, k, do)
    delta = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    args = (q, k, v, do, lse, delta, None, None, True, scale, rounds)
    dq = fa._flash_dq_cuda(*args, out=out)
    dk, dv = fa._flash_dkdv_cuda(*args)
    rdq, rdelta = fa.flash_bwd_dq_reference(q, k, v, out, lse, do,
                                            causal=True, scale=scale)
    rdk, rdv = fa.flash_bwd_dkdv_reference(q, k, v, lse, delta, do,
                                           causal=True, scale=scale)
    torch.cuda.synchronize()
    delta_err = _fp32_err(delta, rdelta, "flash split delta fold", 1e-5)
    dq_err = grad_err(dq, rdq, "flash split dq kernel")
    dkdv_err = max(grad_err(dk, rdk, "flash split dk kernel"),
                   grad_err(dv, rdv, "flash split dv kernel"))
    del dq, dk, dv, rdq, rdelta, rdk, rdv
    dkdv_ms = timer(lambda: fa._flash_dkdv_cuda(*args), iters=10)
    dq_ms = timer(lambda: fa._flash_dq_cuda(*args, out=out), iters=10)
    split_ms = timer(lambda: fa._flash_bwd_cuda(
        q, k, v, out, lse, do, None, None, True, scale, split=True), iters=10)
    single_ms = timer(lambda: fa._flash_bwd_cuda(
        q, k, v, out, lse, do, None, None, True, scale, split=False),
        iters=10)
    plain_ms = timer(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=True, scale=scale), iters=3, warmup=1)
    lib_ms = timer(_grad_of(torch, lambda a, b_, c: (
        F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                       scale=scale)), (q, k, v), do),
        iters=10)
    pairs = b * h * s * (s + 1) // 2
    # dk/dv reads q, k, v, do, lse, delta and writes dk, dv; dq reads q, k,
    # v, do, o, lse and writes dq and delta
    sd2 = b * h * s * d * 2
    dkdv_bound = bound(4 * 2.0 * d * pairs, 6 * sd2 + 2 * b * h * s * 4)
    dq_bound = bound(3 * 2.0 * d * pairs, 6 * sd2 + 2 * b * h * s * 4)
    single_bound = bound(5 * 2.0 * d * pairs, 7 * sd2 + 2 * b * h * s * 4)
    del q, k, v, do, out, lse, delta, args

    # the split beside B2 at the s1024 train cell's shape (the single pass
    # runs there), as data for B2's redesign
    q, k, v, do = (rand(8, h, 1024, d) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, True, scale)
    b8 = dict(split_ms=timer(lambda: fa._flash_bwd_cuda(
        q, k, v, out, lse, do, None, None, True, scale, split=True)),
        single_pass_ms=timer(lambda: fa._flash_bwd_cuda(
            q, k, v, out, lse, do, None, None, True, scale, split=False)))
    del q, k, v, do, out, lse

    # flash_bwd.cu's split at the O0 long path's shape (fp32)
    q, k, v, do = (rand(b, h, s, d, dtype=torch.float32) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, None, None, True, scale)
    n0 = _split_counts(fa)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, None, None, True,
                                 scale)
    torch.cuda.synchronize()
    check(_split_moved(fa, n0, False),
          "fp32 s4096 did not take flash_bwd.cu's split")
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=True, scale=scale)
    torch.cuda.synchronize()
    f32_errs = {n: _fp32_err(g, r, f"flash split fp32 {n}", FP32_GRAD_TOL)
                for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
    del got, ref
    delta = (do * out).sum(dim=-1)
    args = (q, k, v, do, lse, delta, None, None, True, scale,
            fa._mixed_rounds(q, k, do))
    f32_dkdv_ms = timer(lambda: fa._flash_dkdv_cuda(*args), iters=5)
    f32_dq_ms = timer(lambda: fa._flash_dq_cuda(*args), iters=5)
    f32_plain_ms = timer(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=True, scale=scale), iters=3, warmup=1)
    f32_lib_ms = timer(_grad_of(torch, lambda a, b_, c: (
        F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                       scale=scale)), (q, k, v), do),
        iters=5)
    sd4 = 2 * sd2
    f32_dkdv_bound = bound(4 * 2.0 * d * pairs, 6 * sd4 + 2 * b * h * s * 4,
                           FP32_FLOPS_PER_S)
    f32_dq_bound = bound(3 * 2.0 * d * pairs, 5 * sd4 + 2 * b * h * s * 4,
                         FP32_FLOPS_PER_S)
    del q, k, v, do, out, lse, delta, args

    wgmma = dict(
        route="cuda", source="apex_tpu_torch/csrc/flash_bwd_sm90.cu",
        shape=f"b{b} h{h} s{s} d{d} bf16 causal (also b1 h4 s2304 with "
              "segment ids, padding from 2000)",
        tolerance="2 bf16 ulp + 2% of max, 1% relative norm; the folded "
                  "delta 1e-5 of max; a rerun bitwise",
        plain_ms=plain_ms, library_ms=lib_ms,
        plain="flash_attention_bwd_reference: dq, dk and dv together",
        library="backward of F.scaled_dot_product_attention(is_causal="
                "True): dq, dk and dv together",
        split_ms=split_ms, single_pass_ms=single_ms,
        single_pass_bound_ms=single_bound[0],
        single_pass_max_abs_err=single_err, pair_max_abs_err=errs,
        delta_fold_max_abs_err=delta_err, b8_s1024=b8,
        registers=_sm90_registers(_build))
    simt = dict(
        route="cuda", source="apex_tpu_torch/csrc/flash_bwd.cu",
        shape=f"b{b} h{h} s{s} d{d} fp32 causal (the O0 long path's)",
        tolerance=f"{FP32_GRAD_TOL} of max and in relative norm",
        plain_ms=f32_plain_ms, library_ms=f32_lib_ms,
        plain="flash_attention_bwd_reference: dq, dk and dv together",
        library="backward of F.scaled_dot_product_attention(is_causal="
                "True), fp32: dq, dk and dv together")
    return [
        dict(name="flash_bwd_dkdv_sm90", replaces="apex_tpu/ops/"
             "flash_attention.py:558", max_abs_err=dkdv_err, ms=dkdv_ms,
             bound_ms=dkdv_bound[0], bound_by=dkdv_bound[1], **wgmma),
        dict(name="flash_bwd_dq_sm90", replaces="apex_tpu/ops/"
             "flash_attention.py:671", max_abs_err=dq_err, ms=dq_ms,
             bound_ms=dq_bound[0], bound_by=dq_bound[1], **wgmma),
        dict(name="flash_bwd_dkdv", replaces="apex_tpu/ops/flash_attention"
             ".py:558", max_abs_err=max(f32_errs["dk"], f32_errs["dv"]),
             ms=f32_dkdv_ms, bound_ms=f32_dkdv_bound[0],
             bound_by=f32_dkdv_bound[1], **simt),
        dict(name="flash_bwd_dq", replaces="apex_tpu/ops/flash_attention.py"
             ":671", max_abs_err=f32_errs["dq"], ms=f32_dq_ms,
             bound_ms=f32_dq_bound[0], bound_by=f32_dq_bound[1], **simt),
    ]


# the ResNet-50 head (n256 V1000 fp32, the bench's smoothing) and the GPT's
# vocabulary at its token count (n8192 V32768 bf16, smoothing 0.1 and 0)
XENT_SHAPES = ((256, 1000, "float32", (0.1,)),
               (8192, 32768, "bfloat16", (0.1, 0.0)))


def check_xentropy(torch, timer):
    """Both softmax cross-entropy kernels through the autograd function
    against the plain twin, with rows labelled ``padding_idx`` (0); the
    forward and the backward timed apart beside the twin's halves and
    ``F.cross_entropy`` with the same smoothing."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import fused_ce as xe
    gen = torch.Generator(device="cuda").manual_seed(12)
    fwd, bwd = [], []
    for n, V, dt, smoothings in XENT_SHAPES:
        dtype = getattr(torch, dt)
        x = (3 * torch.randn(n, V, generator=gen, device="cuda")).to(dtype)
        y = torch.randint(0, V, (n,), generator=gen, device="cuda")
        y[::16] = 0
        dl = torch.full((n,), 1.0 / n, device="cuda")
        f_err = b_err = 0.0
        for ls in smoothings:
            xa = x.clone().requires_grad_()
            xb = x.clone().requires_grad_()
            la = xe.softmax_cross_entropy_with_smoothing(xa, y, ls, 0)
            ga, = torch.autograd.grad(la, xa, dl)
            lb = xe.softmax_cross_entropy_reference(xb, y, ls, 0)
            gb, = torch.autograd.grad(lb, xb, dl)
            torch.cuda.synchronize()
            # fp32 losses: sums and exponentials in another order
            d = (la - lb).abs()
            check(bool((d <= 1e-5 * lb.abs() + 1e-6).all()),
                  f"xentropy loss n{n} V{V} ls{ls}: max err {d.max().item()}")
            check(not bool(la[::16].any()) and not bool(ga[::16].any()),
                  "xentropy: a padding row got a loss or a gradient")
            f_err = max(f_err, d.max().item())
            # gradients: one rounding of an fp32 value to the logits' dtype
            # on each side, p recomputed from (m, l) against exp(x - lse)
            ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
            d = (ga.float() - gb.float()).abs()
            floor = 1e-6 * gb.float().abs().max().item() + 1e-12
            check(bool((d <= gb.float().abs() * 2 * ulp + floor).all()),
                  f"xentropy grad n{n} V{V} ls{ls}: max err "
                  f"{d.max().item()}")
            b_err = max(b_err, d.max().item())
            del xa, xb, la, lb, ga, gb
        ls = smoothings[0]
        tgt = y.to(torch.int32)
        loss, m, l = xe._xent_fwd_cuda(x, tgt, ls)
        _, lse = xe._xent_fwd(x, y, ls, None)
        itm = x.element_size()
        f_ms = timer(lambda: xe._xent_fwd_cuda(x, tgt, ls))
        f_plain = timer(lambda: xe._xent_fwd(x, y, ls, None), iters=10)
        f_lib = timer(lambda: F.cross_entropy(x, y, label_smoothing=ls,
                                              reduction="none"))
        b_ms = timer(lambda: xe._xent_bwd_cuda(x, tgt, m, l, dl, ls))
        b_plain = timer(lambda: xe._xent_bwd(x, y, lse, dl, ls, None),
                        iters=10)
        b_lib = timer(_grad_of(torch, lambda a: F.cross_entropy(
            a, y, label_smoothing=ls, reduction="none").float(), (x,), dl))
        # ~10 fp32 operations and two exponentials an element forward, ~6
        # and one backward, on the CUDA cores
        fb = bound(12.0 * n * V, n * V * itm + n * 4 + 3 * n * 4,
                   FP32_FLOPS_PER_S)
        bb = bound(7.0 * n * V, 2 * n * V * itm + 4 * n * 4,
                   FP32_FLOPS_PER_S)
        shape = f"n{n} V{V} {dt} smoothing {ls}"
        fwd.append(dict(shape=shape, max_abs_err=f_err, ms=f_ms,
                        plain_ms=f_plain, library_ms=f_lib, bound_ms=fb[0],
                        bound_by=fb[1]))
        bwd.append(dict(shape=shape, max_abs_err=b_err, ms=b_ms,
                        plain_ms=b_plain, library_ms=b_lib, bound_ms=bb[0],
                        bound_by=bb[1]))
        del x, y, loss, m, l, lse
    common = dict(
        route="triton", source="apex_tpu_torch/ops/fused_ce.py",
        shape="n256 V1000 fp32 smoothing 0.1 (the ResNet-50 head; by_shape: "
              "n8192 V32768 bf16, smoothing 0.1 and 0 checked), rows "
              "labelled padding_idx 0")
    out = []
    for name, replaces, rows, tol, lib in (
            ("xentropy_fwd", "apex_tpu/ops/fused_ce.py:111", fwd,
             "fp32 loss 1e-5 relative + 1e-6",
             "F.cross_entropy(label_smoothing=s, reduction='none')"),
            ("xentropy_bwd", "apex_tpu/ops/fused_ce.py:139", bwd,
             "2 ulps of the logits' dtype + 1e-6 of max",
             "autograd backward of that F.cross_entropy")):
        main = rows[0]
        out.append(dict(name=name, replaces=replaces,
                        max_abs_err=max(r["max_abs_err"] for r in rows),
                        tolerance=tol, ms=main["ms"],
                        plain_ms=main["plain_ms"],
                        library_ms=main["library_ms"], library=lib,
                        bound_ms=main["bound_ms"],
                        bound_by=main["bound_by"], by_shape=rows, **common))
    return out


# the 12-layer h1024 GPT's parameters, every one in the ZeRO flat buffer
# (148 leaves), and a ragged size that is no multiple of 4
MTU_SIZES = (185_759_744, 1_000_003)
MTU_BETAS = (0.9, 0.999)
# (kind, adam_w_mode, weight_decay, bias_correction, grad_averaging)
MTU_MODES = (("adam", True, 0.01, True, True),       # AdamW, the ZeRO path
             ("adam", False, 0.01, True, True),      # L2 into the gradient
             ("adam", True, 0.01, False, True),      # no bias correction
             ("lamb", True, 0.01, True, True),       # LAMB, beta3 = 1 - b1
             ("lamb", True, 0.01, True, False))      # LAMB, beta3 = 1


def _mtu_hyper(mode):
    kind, aw, wd, bc, ga = mode
    return dict(kind=kind, betas=MTU_BETAS, eps=1e-8, weight_decay=wd,
                adam_w_mode=aw, bias_correction=bc, grad_averaging=ga)


def check_multi_tensor_update(torch, timer):
    """B13 against its plain version (``zero/update.py`` + ``torch.where``
    on skip), bitwise on every output, in each mode and with a set skip
    flag, at the GPT's parameter count and at a ragged size; timed at the
    GPT's size beside the plain version and one fused AdamW step of
    ``torch.optim`` over the same buffers (timed only: it adds eps outside
    the bias correction, apex inside)."""
    from apex_tpu_torch.zero import fused_update as fu
    gen = torch.Generator(device="cuda").manual_seed(13)
    lr = 3e-4
    step = torch.full((), 7, dtype=torch.int32, device="cuda")
    skip = torch.ones((), dtype=torch.bool, device="cuda")
    checked = []
    for n in MTU_SIZES:
        def rand(scale):
            return scale * torch.randn(n, generator=gen, device="cuda")
        p, g, m = rand(0.05), rand(0.01), rand(1e-3)
        v = rand(1e-2).square_()
        for mode in MTU_MODES:
            hyper = _mtu_hyper(mode)
            scal = fu.update_scalars(lr, step, MTU_BETAS, hyper[
                "bias_correction"], "cuda")
            ref = fu.fused_shard_update_reference(
                p, g, m, v, step, lr=scal[0], corrections=(scal[1], scal[2]),
                **hyper)
            kp, km, kv = p.clone(), m.clone(), v.clone()
            got = fu.fused_shard_update(kp, g, km, kv, step, lr=lr, **hyper)
            torch.cuda.synchronize()
            for name, a, r in zip(("p/upd", "m", "v"), got, ref):
                check(torch.equal(a, r), f"B13 {mode} n{n} {name}: max err "
                      f"{(a - r).abs().max().item()}")
            del ref, got
            for dst, src in ((kp, p), (km, m), (kv, v)):
                dst.copy_(src)
            got = fu.fused_shard_update(kp, g, km, kv, step, lr=lr,
                                        skip=skip, **hyper)
            torch.cuda.synchronize()
            check(torch.equal(kp, p) and torch.equal(km, m)
                  and torch.equal(kv, v), f"B13 {mode} n{n}: skip wrote")
            if hyper["kind"] == "lamb":
                check(not bool(got[0].any()), "B13 LAMB skip: upd not zero")
            checked.append(f"{mode[0]} aw{int(mode[1])} bc{int(mode[3])} "
                           f"ga{int(mode[4])} n{n}")
            del kp, km, kv, got
        if n != MTU_SIZES[0]:
            del p, g, m, v
            continue
        adamw = _mtu_hyper(MTU_MODES[0])
        lamb = _mtu_hyper(MTU_MODES[3])
        kp, km, kv = p.clone(), m.clone(), v.clone()
        ms = timer(lambda: fu.fused_shard_update(kp, g, km, kv, step, lr=lr,
                                                 **adamw), iters=20)
        lamb_ms = timer(lambda: fu.fused_shard_update(kp, g, km, kv, step,
                                                      lr=lr, **lamb),
                        iters=20)
        plain_ms = timer(lambda: fu.fused_shard_update_reference(
            p, g, m, v, step, lr=lr, **adamw), iters=5, warmup=1)
        del kp, km, kv
        flat = torch.nn.Parameter(p.clone())
        flat.grad = g
        lib = torch.optim.AdamW([flat], lr=lr, betas=MTU_BETAS, eps=1e-8,
                                weight_decay=0.01, fused=True)
        lib_ms = timer(lib.step, iters=20)
        del lib, flat
        big = (n, ms, lamb_ms, plain_ms, lib_ms)
        del p, g, m, v
        torch.cuda.empty_cache()
    n, ms, lamb_ms, plain_ms, lib_ms = big
    # reads p, g, m, v and writes p (or upd), m, v: 7 fp32 buffers; ~15
    # fp32 operations an element on the CUDA cores
    t_bound, by = bound(15.0 * n, 7 * 4 * n, FP32_FLOPS_PER_S)
    return dict(name="multi_tensor_update", route="cuda",
                source="apex_tpu_torch/csrc/multi_tensor_update.cu",
                replaces="apex_tpu/zero/fused_update.py:54",
                shape=f"n{n} fp32 flat (the 12-layer h1024 GPT), in place; "
                      f"also n{MTU_SIZES[1]}",
                max_abs_err=0.0, tolerance="bitwise (torch.equal) on every "
                "output, every mode, and under skip",
                checked=checked, ms=ms, lamb_ms=lamb_ms, plain_ms=plain_ms,
                bound_ms=t_bound, bound_by=by, library_ms=lib_ms,
                library="torch.optim.AdamW(fused=True).step() over the same "
                        "flat fp32 buffer (eps placement differs)")


# ---------------------------------------------------------------------------
# serve path
# ---------------------------------------------------------------------------

N_REQUESTS, N_NEW = 16, 64

# the serve paths: the bf16 engine (PR 1), fp8 weights + fp8 KV, and
# speculative decoding over fp8 weights with the default 6-layer draft
SERVE_PATHS = {
    "serve": {},
    "serve-fp8": dict(fp8_weights=True, fp8_kv=True),
    "serve-spec-fp8w": dict(fp8_weights=True, spec_k=4),
}


def gpt_config(max_seq_len=1024):
    import torch
    from apex_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(vocab_size=32768, max_seq_len=max_seq_len,
                     hidden_size=1024, num_layers=12, num_heads=16,
                     dtype=torch.bfloat16)


def make_engine(cfg, params, **kw):
    from apex_tpu_torch.serve import ServeEngine
    return ServeEngine(cfg, params, num_pages=72, page_size=128,
                       max_seq_len=1024, max_prompt_len=512, max_batch=8,
                       record_logits=True, **kw)


def counters():
    """Each kernel's launch counter as (wrapper, attribute): the fp8
    variant of paged decode counts apart from the bf16 kernel, the split
    flash backward's two kernels apart from the single pass, and the
    wgmma route of the flash forward, the single pass and the split
    (``*_sm90``) apart from both routes together (``flash_fwd``,
    ``flash_bwd``, ``flash_bwd_dkdv``/``flash_bwd_dq``;
    :func:`read_counters` leaves flash_fwd.cu's and flash_bwd.cu's own
    launches there)."""
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fp8_matmul as mm
    from apex_tpu_torch.ops import fused_ce as xe
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import lm_head_ce as ce
    from apex_tpu_torch.scripts import bottleneck_proto as bp
    from apex_tpu_torch.scripts import vpu_probe as vp
    from apex_tpu_torch.zero import fused_update as fu
    return {"flash_fwd": (fa.flash_attention, "launches"),
            "flash_fwd_sm90": (fa.flash_attention, "wgmma_launches"),
            "paged_decode": (fa.paged_decode_attention, "launches"),
            "paged_decode_fp8": (fa.paged_decode_attention, "fp8_launches"),
            "layer_norm_fwd": (ln.fused_layer_norm_affine, "launches"),
            "flash_bwd": (fa.flash_attention_bwd, "launches"),
            "flash_bwd_fused_sm90": (fa.flash_attention_bwd,
                                     "wgmma_launches"),
            "layer_norm_bwd": (ln.layer_norm_bwd, "launches"),
            "lm_head_ce_fwd": (ce.lm_head_ce_fwd, "launches"),
            "lm_head_ce_bwd": (ce.lm_head_ce_bwd, "launches"),
            "lm_head_ce_fwd_f32": (ce.lm_head_ce_fwd, "f32_launches"),
            "lm_head_ce_bwd_f32": (ce.lm_head_ce_bwd, "f32_launches"),
            "fp8_matmul": (mm.fp8_dequant_matmul, "launches"),
            "flash_bwd_dkdv": (fa.flash_attention_bwd, "dkdv_launches"),
            "flash_bwd_dq": (fa.flash_attention_bwd, "dq_launches"),
            "flash_bwd_dkdv_sm90": (fa.flash_attention_bwd,
                                    "wgmma_dkdv_launches"),
            "flash_bwd_dq_sm90": (fa.flash_attention_bwd,
                                  "wgmma_dq_launches"),
            "xentropy_fwd": (xe.softmax_cross_entropy_with_smoothing,
                             "launches"),
            "xentropy_bwd": (xe.softmax_cross_entropy_with_smoothing,
                             "bwd_launches"),
            "multi_tensor_update": (fu.fused_shard_update, "launches"),
            "multi_tensor_update_lamb": (fu.fused_shard_update,
                                         "lamb_launches"),
            "bottleneck": (bp.fused_block, "launches"),
            "vpu_probe": (vp.vpu_probe_kernel, "launches")}


def reset_counters():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counters():
    """Launches by kernel since :func:`reset_counters`; the flash
    counters of both routes less the wgmma route's, so that ``flash_fwd``,
    ``flash_bwd``, ``flash_bwd_dkdv`` and ``flash_bwd_dq`` count
    flash_fwd.cu's and flash_bwd.cu's kernels alone, and the LM-head CE's
    less the fp32 route's, so that ``lm_head_ce_fwd``/``_bwd`` count the
    wgmma route's (``lm_head_ce_sm90.cu``) and ``*_f32`` the fp32 route's
    (``lm_head_ce.cu``)."""
    out = {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}
    out["lm_head_ce_fwd"] -= out["lm_head_ce_fwd_f32"]
    out["lm_head_ce_bwd"] -= out["lm_head_ce_bwd_f32"]
    out["flash_fwd"] -= out["flash_fwd_sm90"]
    out["flash_bwd"] -= out["flash_bwd_fused_sm90"]
    out["flash_bwd_dkdv"] -= out["flash_bwd_dkdv_sm90"]
    out["flash_bwd_dq"] -= out["flash_bwd_dq_sm90"]
    return out


def serve_prompts(cfg):
    rng = np.random.RandomState(0)
    lens = rng.randint(64, 513, size=N_REQUESTS)
    return [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]


def expected_serve_launches(path, eng, n_prefill, n_decode):
    """Launches of each kernel over a drained run: per layer one flash
    forward per prefill and one paged decode per decode step (verify call
    under speculation), 2 LayerNorms per layer plus the final one per
    forward, 4 block linears per layer through the fp8 matmul with fp8
    weights; a draft call runs the draft's layers the same way."""
    L = eng.cfg.num_layers
    exp = {k: 0 for k in counters()}
    steps = n_prefill + n_decode
    exp["flash_fwd_sm90"] = L * n_prefill       # bf16 d64: the wgmma route
    exp["layer_norm_fwd"] = (2 * L + 1) * steps
    decode = "paged_decode_fp8" if eng.ccfg.fp8 else "paged_decode"
    exp[decode] = L * n_decode
    if eng.fp8_weights:
        exp["fp8_matmul"] = 4 * L * steps
    if eng.spec_k:
        Ld, calls = eng.draft_cfg.num_layers, eng.draft_calls
        exp["paged_decode"] += Ld * calls
        exp["layer_norm_fwd"] += (2 * Ld + 1) * calls
        exp["fp8_matmul"] += 4 * Ld * calls
    return exp


def run_serve_path(torch, cfg, params, path, n_requests=N_REQUESTS):
    """Drain ``n_requests`` requests through the engine of ``path`` after a
    warm-up engine (cuBLAS handles, Triton's first compile and the
    kernels' first loads stay out of the timed, counted run)."""
    kw = SERVE_PATHS[path]
    warm = make_engine(cfg, params, **kw)
    warm.add_request(list(range(1, 65)), 6)
    warm.run()
    del warm
    torch.cuda.synchronize()

    eng = make_engine(cfg, params, **kw)
    prompts = serve_prompts(cfg)[:n_requests]
    ids = [eng.add_request(p, N_NEW) for p in prompts]
    reset_counters()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()

    check(all(len(out[i]) == N_NEW for i in ids),
          f"{path}: a request did not return {N_NEW} tokens")
    check(eng.sched.allocator.free_pages == eng.ccfg.num_pages - 1,
          f"{path}: pages were not all returned")
    check(eng.slots == [None] * eng.max_batch, f"{path}: a slot leaked")
    check(sum(eng.seqs[i].n_preemptions for i in ids) == 0,
          f"{path}: a preemption happened: the launch counts assume none")
    n_prefill = len(eng.prefill_times)
    n_decode = len(eng.decode_step_times)
    check(n_prefill == n_requests, f"{path}: {n_prefill} prefills")
    expect = expected_serve_launches(path, eng, n_prefill, n_decode)
    for k in expect:
        check(launches[k] == expect[k],
              f"{path} {k}: {launches[k]} launches, expected {expect[k]}")
    if eng.fp8_weights:
        check(launches["fp8_matmul"] > 0, f"{path}: fp8 matmul never ran")
    if eng.ccfg.fp8:
        check(launches["paged_decode_fp8"] > 0 and
              launches["paged_decode"] == 0,
              f"{path}: decode did not go through the fp8 kernel alone")

    dec_ms = [1e3 * t for t in eng.decode_step_times]
    full = [1e3 * t for t, n in zip(eng.decode_step_times,
                                    eng.decode_step_sizes)
            if n == eng.max_batch]
    stats = dict(
        path=path, engine_flags=kw, requests=n_requests, new_tokens=N_NEW,
        wall_s=wall, tokens_per_s=eng.tokens_generated / wall,
        prefill_ms_by_len=sorted((n, 1e3 * t) for n, t in eng.prefill_times),
        prefill_ms_median=float(np.median([1e3 * t for _, t in
                                           eng.prefill_times])),
        decode_steps=n_decode,
        decode_step_ms_median=float(np.median(dec_ms)),
        decode_step_ms_p90=float(np.percentile(dec_ms, 90)),
        decode_tokens_per_s=sum(eng.decode_step_sizes)
        / sum(eng.decode_step_times),
        pool_bytes=eng.ccfg.pool_bytes(),
        launches=launches)
    if full:
        stats.update(decode_step_ms_batch8_median=float(np.median(full)),
                     decode_step_ms_batch8_p90=float(np.percentile(full, 90)),
                     decode_steps_batch8=len(full))
    if eng.spec_k:
        stats.update(spec_k=eng.spec_k, draft_layers=eng.draft_cfg.num_layers,
                     spec_rounds=eng.spec_rounds,
                     draft_calls=eng.draft_calls,
                     draft_tokens=eng.draft_tokens,
                     accepted_tokens=eng.accepted_tokens,
                     accept_rate=eng.accepted_tokens
                     / max(1, eng.draft_tokens),
                     tokens_per_round=(eng.accepted_tokens
                                       + eng.spec_rounds)
                     / max(1, eng.spec_rounds),
                     draft_pool_bytes=eng.draft_ccfg.pool_bytes())
    return eng, ids, out, stats


def spec_identity(torch, cfg, params, spec, ids, out):
    """The speculative engine's tokens against a plain ``fp8_weights``
    engine's on the same requests (the JAX contract: a verify row is
    bitwise the plain-decode row). Returns the first differing (request,
    token index) or None, and how many recorded logits rows are bitwise
    equal."""
    plain = make_engine(cfg, params, fp8_weights=True)
    pids = [plain.add_request(p, N_NEW) for p in serve_prompts(cfg)]
    pout = plain.run()
    torch.cuda.synchronize()
    first = None
    for sid, pid in zip(ids, pids):
        a, b = out[sid], pout[pid]
        diff = [i for i in range(N_NEW) if a[i] != b[i]]
        if diff and first is None:
            first = (sid, diff[0])
    rows = same = 0
    for sid, pid in zip(ids, pids):
        for pos, row in plain.logits_log[pid].items():
            other = spec.logits_log[sid].get(pos)
            if other is not None:
                rows += 1
                same += int(np.array_equal(row, other))
    return dict(requests=len(ids), first_token_divergence=first,
                logits_rows_compared=rows, logits_rows_bitwise_equal=same)


def teacher_forced(torch, cfg, params, eng, ids):
    """The plain no-cache forward over prompt + generated tokens against the
    engine's recorded logits, every generated position of two requests.
    ``params`` is what the engine serves (the quantized view under fp8
    weights, whose plain forward runs the dequant-matmul's plain version)."""
    from apex_tpu_torch.serve.model import full_forward_logits
    worst, worst_gap, n_pos, n_flip, mag = 0.0, 0.0, 0, 0, 0.0
    for sid in ids[:2]:
        seq = eng.seqs[sid]
        lp = len(seq.prompt)
        positions = list(range(lp, lp + N_NEW))
        S = lp + N_NEW
        for lo in range(0, len(positions), 16):
            chunk = positions[lo:lo + 16]
            batch = np.zeros((len(chunk), S), np.int64)
            for r, p in enumerate(chunk):
                batch[r, :p] = seq.tokens[:p]
            with torch.no_grad():
                ref = full_forward_logits(
                    cfg, params, torch.from_numpy(batch).cuda(),
                    torch.tensor(chunk, device="cuda"), reference=True)
            ref = ref.cpu().numpy()
            for r, p in enumerate(chunk):
                got = eng.logits_log[sid][p]
                worst = max(worst, float(np.abs(got - ref[r]).max()))
                mag = max(mag, float(np.abs(ref[r]).max()))
                n_pos += 1
                a, b = int(got.argmax()), int(ref[r].argmax())
                if a != b:
                    n_flip += 1
                    worst_gap = max(worst_gap, float(ref[r][b] - ref[r][a]))
    return dict(positions=n_pos, max_abs_diff=worst, max_abs_logit=mag,
                argmax_flips=n_flip, worst_flip_gap=worst_gap)


# fp8 KV against the plain forward over the same quantized weights: the
# e4m3 round trip of K and V is the only difference besides the kernels';
# the bound tests/test_serve.py holds the JAX fp8 cache to
TF_FP8_FRAC = 0.15

# max |logit| diff, bf16 engine vs the plain forward: ~6 bf16 ulps at the
# largest logits (|logit| < 4, ulp 2^-6); an argmax flip is allowed only
# where the plain logits of the two tokens are within 2 * TF_TOL
TF_TOL = 0.1
TF_TIE = 2 * TF_TOL


# ---------------------------------------------------------------------------
# train path
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS, LR = 8, 1024, 8, 3e-4
# every flash launch of the bf16 d64 step on the wgmma route
TRAIN_PER_STEP = {"flash_fwd": 0, "flash_fwd_sm90": 12, "flash_bwd": 0,
                  "flash_bwd_fused_sm90": 12, "layer_norm_fwd": 25,
                  "layer_norm_bwd": 25, "lm_head_ce_fwd": 1,
                  "lm_head_ce_bwd": 1, "lm_head_ce_fwd_f32": 0,
                  "lm_head_ce_bwd_f32": 0, "paged_decode": 0,
                  "paged_decode_fp8": 0, "fp8_matmul": 0,
                  "flash_bwd_dkdv": 0, "flash_bwd_dq": 0,
                  "flash_bwd_dkdv_sm90": 0, "flash_bwd_dq_sm90": 0,
                  "xentropy_fwd": 0,
                  "xentropy_bwd": 0, "multi_tensor_update": 0,
                  "multi_tensor_update_lamb": 0}


def train_batch(torch, cfg, b=TRAIN_B, s=TRAIN_S):
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int64)
    ids = torch.from_numpy(ids).cuda()
    return ids, torch.roll(ids, -1, dims=1)


def o2_setup(torch, cfg):
    """The O2 recipe: init -> amp.initialize -> cast_params -> opt.init ->
    make_train_step."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import GPT
    from apex_tpu_torch.optimizers import FusedAdam
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    amp_model, opt = amp.initialize(model, FusedAdam(lr=LR), opt_level="O2",
                                    loss_scale="dynamic", verbosity=0)
    amp_model.cast_params()
    state = opt.init(model.parameters())
    step = amp.make_train_step(lambda m, i, l: m.loss(i, l), opt)
    return model, opt, state, step


def run_train_path(torch, cfg):
    model, opt, state, step = o2_setup(torch, cfg)
    ids, labels = train_batch(torch, cfg)
    sstate = opt._scaler.state
    # warm-up: cuBLAS handles and Triton's compiles stay out of the count
    _, state, sstate, _ = step(model, state, sstate, ids, labels)
    torch.cuda.synchronize()
    scale0 = float(sstate.loss_scale)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_counters()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        _, state, sstate, loss = step(model, state, sstate, ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_counters()
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(float(sstate.loss_scale) == scale0 == 2.0 ** 16,
          "the loss scale moved (an overflow) during the timed steps")
    for k, per in TRAIN_PER_STEP.items():
        check(launches[k] == per * TRAIN_STEPS,
              f"train {k}: {launches[k]} launches, expected "
              f"{per * TRAIN_STEPS}")
    ms = [1e3 * t for t in times]
    stats = dict(steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                 losses=losses, warmup_loss_scale=scale0,
                 step_ms_median=float(np.median(ms)),
                 step_ms_p90=float(np.percentile(ms, 90)),
                 step_ms_all=ms,
                 tokens_per_s=TRAIN_B * TRAIN_S / (np.median(ms) / 1e3),
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches=launches)
    return model, opt, state, sstate, step, stats


def step_phases(torch, cfg, model, opt, state, sstate, reps=3):
    """Device time of each phase of the train step, by CUDA events around
    the functions ``make_train_step`` calls, called one by one in its
    order: forward + backward of the scaled loss, unscale (gradient
    concatenation, overflow check, multiply), the optimizer step on the
    flat buffer, the scaler update. Median of ``reps``; returns the phase
    times and the state after them."""
    from apex_tpu_torch.amp import scaler as scaler_mod
    ids, labels = train_batch(torch, cfg)
    params = [p for g in opt.param_groups for p in g["params"]]
    names = ("forward_backward", "unscale", "optimizer", "scaler_update")
    ms = {k: [] for k in names}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        ev[0].record()
        scaler_mod.scale_value(model.loss(ids, labels), sstate).backward()
        ev[1].record()
        g32, found_inf = scaler_mod.unscale(
            [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params], sstate)
        for p in params:
            p.grad = None
        ev[2].record()
        state = opt.apply_flat(state, g32, skip=found_inf)
        ev[3].record()
        sstate = opt._scaler.update_state(sstate, found_inf)
        ev[4].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            ms[k].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: float(np.median(v)) for k, v in ms.items()}, state, sstate


# loss through the kernels vs the plain versions, same bf16 params: the
# kernels round p (flash) at the same points as the plain forward; only
# summation order differs, through 12 layers. Measured on the H100 at
# full size: 10.60548 vs 10.60557, a gap of 9e-5 (PERF.md).
GRAD_LOSS_TOL = 1e-3
# per-parameter relative norm of the gradient difference: the backward
# kernels round p, ds and the softmax-gradient tile to bf16 before their
# products (the plain versions, differentiated by autograd, keep fp32).
# Measured on the H100 at full size: worst 1.26 %, median 0.90 %.
GRAD_NORM_TOL = 3e-2


def grad_check(torch, cfg):
    model, _, _, _ = o2_setup(torch, cfg)
    ids, labels = train_batch(torch, cfg)
    params = list(model.named_parameters())
    loss = model.loss(ids, labels)
    grads = torch.autograd.grad(loss, [p for _, p in params])
    ref_loss = model.loss(ids, labels, reference=True)
    ref = torch.autograd.grad(ref_loss, [p for _, p in params])
    loss, ref_loss = loss.detach(), ref_loss.detach()
    dloss = abs(float(loss) - float(ref_loss))
    check(dloss <= GRAD_LOSS_TOL, f"loss kernels {float(loss)} vs plain "
          f"{float(ref_loss)}")
    worst = []
    for (name, _), g, r in zip(params, grads, ref):
        rel = ((g.float() - r.float()).norm()
               / r.float().norm().clamp_min(1e-30)).item()
        worst.append((rel, name))
        check(rel <= GRAD_NORM_TOL, f"grad {name}: relative norm error {rel}")
    worst.sort(reverse=True)
    return dict(layers=cfg.num_layers, loss_kernels=float(loss),
                loss_plain=float(ref_loss), loss_abs_diff=dloss,
                params=len(params), worst_rel_norm=worst[:5],
                median_rel_norm=float(np.median([w for w, _ in worst])))


def overflow_check(torch, cfg, model, opt, state, sstate):
    """One step whose gradients overflow: the loss times 1e38 (the
    overflow factory of tests/test_amp.py), so loss * scale and the
    gradient seed overflow fp32 and every gradient is inf or nan."""
    from apex_tpu_torch import amp
    ids, labels = train_batch(torch, cfg)
    big = amp.make_train_step(lambda m, i, l: m.loss(i, l) * 1e38, opt)
    g = state.groups[0]
    before = (g.master.clone(), {k: v.clone() for k, v in g.slots.items()},
              int(g.step), [p.detach().clone() for p in model.parameters()])
    scale0 = float(sstate.loss_scale)
    _, state2, sstate2, loss = big(model, state, sstate, ids, labels)
    torch.cuda.synchronize()
    g2 = state2.groups[0]
    check(torch.equal(g2.master, before[0]), "overflow: master changed")
    for k, v in before[1].items():
        check(torch.equal(g2.slots[k], v), f"overflow: {k} changed")
    check(int(g2.step) == before[2], "overflow: step counter moved")
    check(all(torch.equal(p, b) for p, b in zip(model.parameters(),
                                                before[3])),
          "overflow: model params changed")
    check(bool(sstate2.overflow), "overflow: not detected")
    check(float(sstate2.loss_scale) == scale0 / 2, "overflow: scale not "
          "halved")
    return dict(loss=float(loss), scale_before=scale0,
                scale_after=float(sstate2.loss_scale), step=int(g2.step))


# ---------------------------------------------------------------------------
# long-sequence GPT training: the same O2 FusedAdam step at b2 s4096
# (bench.py's _bench_gpt_long_seq), past the flash backward's gate
# ---------------------------------------------------------------------------

LONG_B, LONG_S, LONG_STEPS = 2, 4096, 4
# every split launch of the bf16 step takes the wgmma route
LONG_PER_STEP = {**TRAIN_PER_STEP, "flash_bwd_fused_sm90": 0,
                 "flash_bwd_dkdv": 0,
                 "flash_bwd_dq": 0, "flash_bwd_dkdv_sm90": 12,
                 "flash_bwd_dq_sm90": 12}


def run_long_seq_path(torch):
    cfg = gpt_config(max_seq_len=LONG_S)
    model, opt, state, step = o2_setup(torch, cfg)
    ids, labels = train_batch(torch, cfg, LONG_B, LONG_S)
    sstate = opt._scaler.state
    _, state, sstate, _ = step(model, state, sstate, ids, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_counters()
    for _ in range(LONG_STEPS):
        t0 = time.perf_counter()
        _, state, sstate, loss = step(model, state, sstate, ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_counters()
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite s4096 loss: {losses}")
    for k, per in LONG_PER_STEP.items():
        check(launches[k] == per * LONG_STEPS,
              f"train s{LONG_S} {k}: {launches[k]} launches, expected "
              f"{per * LONG_STEPS}")
    ms = [1e3 * t for t in times]
    stats = dict(steps=LONG_STEPS, batch=LONG_B, seq=LONG_S, losses=losses,
                 step_ms_median=float(np.median(ms)),
                 step_ms_p90=float(np.percentile(ms, 90)), step_ms_all=ms,
                 tokens_per_s=LONG_B * LONG_S / (np.median(ms) / 1e3),
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches=launches)
    box = [state, sstate]

    def one():
        _, box[0], box[1], _ = step(model, box[0], box[1], ids, labels)

    return stats, _profile(torch, one, 2)


# ---------------------------------------------------------------------------
# ResNet-50 O2 training (bench.py's _build_step): FusedSGD, label-smoothed
# softmax cross entropy through the fused kernels, b256 224x224
# ---------------------------------------------------------------------------

RN_B, RN_STEPS = 256, 8
RN_PER_STEP = {k: 0 for k in TRAIN_PER_STEP}
RN_PER_STEP.update(xentropy_fwd=1, xentropy_bwd=1)


def rn50_batch(torch):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(RN_B, 3, 224, 224).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, RN_B).astype(np.int64))
    return (x.cuda().contiguous(memory_format=torch.channels_last),
            y.cuda())


def rn50_setup(torch):
    """The bench's recipe: ResNet50(dtype=bf16) -> amp.initialize(O2,
    FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)) -> cast_params ->
    opt.init -> make_train_step over mean(softmax_cross_entropy_with_
    smoothing(logits, y, 0.1)). Random weights from seed 0, channels-last
    layout for the convs."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import ResNet50
    from apex_tpu_torch.ops import softmax_cross_entropy_with_smoothing
    from apex_tpu_torch.optimizers import FusedSGD
    model = ResNet50.init_params(num_classes=1000, dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(0),
                                 device="cuda")
    model = model.to(memory_format=torch.channels_last)
    amp_model, opt = amp.initialize(
        model, FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4),
        opt_level="O2", verbosity=0)
    amp_model.cast_params()
    for name, p in model.named_parameters():
        want = torch.float32 if "_BNWrap" in name else torch.bfloat16
        check(p.dtype == want, f"O2 cast: {name} is {p.dtype}")
    check(all(b.dtype == torch.float32 for b in model.buffers()),
          "O2 cast: a running statistic is not fp32")
    state = opt.init(model.parameters())

    def loss_fn(m, x, y):
        return softmax_cross_entropy_with_smoothing(amp_model(x), y,
                                                    0.1).mean()

    return model, amp_model, opt, state, loss_fn


def run_rn50_path(torch):
    from apex_tpu_torch import amp
    # cuDNN picks its conv algorithms in the warm-up step
    torch.backends.cudnn.benchmark = True
    model, amp_model, opt, state, loss_fn = rn50_setup(torch)
    step = amp.make_train_step(loss_fn, opt)
    x, y = rn50_batch(torch)
    sstate = opt._scaler.state
    # warm-up: cuDNN's algorithm search and Triton's compiles stay out
    _, state, sstate, _ = step(model, state, sstate, x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_counters()
    for _ in range(RN_STEPS):
        t0 = time.perf_counter()
        _, state, sstate, loss = step(model, state, sstate, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_counters()
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"non-finite ResNet-50 loss: {losses}")
    for k, per in RN_PER_STEP.items():
        check(launches[k] == per * RN_STEPS,
              f"train-rn50 {k}: {launches[k]} launches, expected "
              f"{per * RN_STEPS}")
    check(all(p.dtype == torch.float32 for n, p in model.named_parameters()
              if "_BNWrap" in n)
          and all(b.dtype == torch.float32 for b in model.buffers()),
          "ResNet-50: batch-norm params or statistics are not fp32")
    ms = [1e3 * t for t in times]
    stats = dict(steps=RN_STEPS, batch=RN_B, image=224, losses=losses,
                 loss_scale=float(sstate.loss_scale),
                 step_ms_median=float(np.median(ms)),
                 step_ms_p90=float(np.percentile(ms, 90)), step_ms_all=ms,
                 images_per_s=RN_B / (np.median(ms) / 1e3),
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches=launches)
    box = [state, sstate]

    def one():
        _, box[0], box[1], _ = step(model, box[0], box[1], x, y)

    trace_rn = _profile(torch, one, 2)
    return model, amp_model, opt, box[0], stats, trace_rn


# ResNet-50 step through the kernels vs through the plain twin, same
# params, deterministic cuDNN: the logits are identical, so the losses
# differ only by the fp32 CE (kernel vs twin, equal in both readings on the
# H100) and the gradients by the last-bit differences of the fp32 logits'
# gradient, which flip bf16 roundings that 53 bf16 conv and batch-norm
# backwards carry on. Per-parameter relative norm, read in three runs at
# worst 5.9 %, 6.8 % and 9.6 % (each time the stem batch norm's bias, whose
# gradient sums the whole stem activation; every other parameter <= 1.5 %)
# and at median 0.97-0.99 %: held at 25 % for the worst and 3 % for the
# median
RN_LOSS_TOL = 1e-5
RN_GRAD_NORM_TOL = 0.25
RN_GRAD_MEDIAN_TOL = 0.03


def rn50_grad_check(torch, model, amp_model):
    from apex_tpu_torch.ops import fused_ce as xe
    x, y = rn50_batch(torch)
    params = list(model.named_parameters())
    bench, det = torch.backends.cudnn.benchmark, \
        torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        loss = xe.softmax_cross_entropy_with_smoothing(amp_model(x), y,
                                                       0.1).mean()
        grads = torch.autograd.grad(loss, [p for _, p in params])
        ref_loss = xe.softmax_cross_entropy_reference(amp_model(x), y,
                                                      0.1).mean()
        ref = torch.autograd.grad(ref_loss, [p for _, p in params])
    finally:
        torch.backends.cudnn.benchmark = bench
        torch.backends.cudnn.deterministic = det
    loss, ref_loss = loss.item(), ref_loss.item()
    worst = sorted((((g.float() - r.float()).norm()
                     / r.float().norm().clamp_min(1e-30)).item(), name)
                   for (name, _), g, r in zip(params, grads, ref))[::-1]
    out = dict(loss_kernels=loss, loss_plain=ref_loss,
               loss_abs_diff=abs(loss - ref_loss), params=len(params),
               worst_rel_norm=worst[:5],
               median_rel_norm=float(np.median([w for w, _ in worst])))
    log("train-rn50 grad check readings: " + json.dumps(out))
    check(out["loss_abs_diff"] <= RN_LOSS_TOL,
          f"ResNet-50 loss kernels {loss} vs plain {ref_loss}")
    check(worst[0][0] <= RN_GRAD_NORM_TOL,
          f"ResNet-50 grad {worst[0][1]}: relative norm error {worst[0][0]}")
    check(out["median_rel_norm"] <= RN_GRAD_MEDIAN_TOL,
          f"ResNet-50 grads: median relative norm error "
          f"{out['median_rel_norm']}")
    return out


def rn50_overflow_check(torch, model, amp_model, opt, state):
    """A step whose loss overflows under a dynamic scale (the O2 default
    for bf16 is a static 1): masters, momentum buffers and their
    ``initialized`` flag bitwise unchanged, the scale halved."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.ops import softmax_cross_entropy_with_smoothing
    x, y = rn50_batch(torch)
    dyn = amp.LossScaler("dynamic", device="cuda")
    big = amp.make_train_step(
        lambda m, xx, yy: softmax_cross_entropy_with_smoothing(
            amp_model(xx), yy, 0.1).mean() * 1e38, opt, scaler=dyn)
    g = state.groups[0]
    before = (g.master.clone(), {k: v.clone() for k, v in g.slots.items()},
              int(g.step), [p.detach().clone() for p in model.parameters()])
    check(bool(g.slots["initialized"]), "momentum not initialized yet")
    scale0 = float(dyn.state.loss_scale)
    _, state2, sstate2, loss = big(model, state, dyn.state, x, y)
    torch.cuda.synchronize()
    g2 = state2.groups[0]
    check(torch.equal(g2.master, before[0]), "RN50 overflow: master changed")
    for k, v in before[1].items():
        check(g2.slots[k].dtype == v.dtype and torch.equal(g2.slots[k], v),
              f"RN50 overflow: {k} changed")
    check(int(g2.step) == before[2], "RN50 overflow: step counter moved")
    check(all(torch.equal(p, b) for p, b in zip(model.parameters(),
                                                before[3])),
          "RN50 overflow: model params changed")
    check(bool(sstate2.overflow), "RN50 overflow: not detected")
    check(float(sstate2.loss_scale) == scale0 / 2,
          "RN50 overflow: scale not halved")
    return dict(loss=float(loss), scale_before=scale0,
                scale_after=float(sstate2.loss_scale), step=int(g2.step))


# ---------------------------------------------------------------------------
# the repaired shapes and dtypes (ROADMAP §C): each kernel at what the JAX
# package computes and the port raised on before
# ---------------------------------------------------------------------------

# 16-bit flash outputs: two ulps of the dtype (bf16 ulps bound fp16's) plus
# the 4e-3 floor of the bf16 checks (p is rounded to the operands' dtype
# before the PV product); fp32: both sides fp32, the kernel's exponentials
# are __expf (2 ulps) and its sums run in another order
FP32_FWD_TOL = 1e-5
# fp32 gradients: relative norm and largest-value fraction (no rounding of
# p or ds in fp32, so only summation order and __expf)
FP32_GRAD_TOL = 1e-4


def _fp32_err(got, ref, what, tol):
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    lim = tol * max(ref.abs().max().item(), 1.0)
    check(diff.max().item() <= lim, f"{what}: max err {diff.max().item()} "
          f"> {lim}")
    rel = (diff.norm() / ref.norm().clamp_min(1e-30)).item()
    check(rel <= tol, f"{what}: relative norm error {rel} > {tol}")
    return diff.max().item()


def check_flash_repairs(torch):
    """Flash forward and backward (single pass and split) at fp16 and
    fp32, at head dims 80, 96 and 256 (padded to 128 and run at 256), past
    256 (320 padded to 512, and 512: the contraction staged in chunks) and
    fp32 past 128; and over q, k, v of mixed dtypes (promoted, p and ds
    rounded as the JAX kernels round them)."""
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [((bf,) * 3, 80), ((bf,) * 3, 96), ((bf,) * 3, 256),
             ((f16,) * 3, 64), ((f16,) * 3, 128), ((f16,) * 3, 256),
             ((f32,) * 3, 64), ((f32,) * 3, 128), ((f32,) * 3, 256),
             ((bf,) * 3, 320), ((bf,) * 3, 512), ((f16,) * 3, 512),
             ((f32,) * 3, 512), ((f32, bf, bf), 64), ((bf, f32, f32), 64),
             ((bf, bf, f16), 64)]
    out = []
    for dtypes, d in cases:
        b, h, s = 2, 4, 300
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda",
                                   dtype=dt)
                       for dt in (*dtypes, dtypes[0]))
        dtype = dtypes[0] if len(set(dtypes)) == 1 else None
        f0 = fa.flash_attention.launches
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        ro, rl = fa.flash_attention_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        check(fa.flash_attention.launches == f0 + 1, "flash repair: no "
              "kernel launch")
        dnames = "/".join(str(dt)[6:] for dt in dtypes) if dtype is None \
            else str(dtype)[6:]
        name = f"flash {dnames} d{d}"
        rec = dict(dtype=dnames, d=d, shape=f"b{b} h{h} s{s} causal",
                   kernel_head_dim=fa.kernel_head_dim(d))
        check(o.dtype == dtypes[0], f"{name}: output dtype {o.dtype}")
        if dtype == torch.float32:
            rec["fwd_err"] = _fp32_err(o, ro, name, FP32_FWD_TOL)
        else:
            rec["fwd_err"] = bf16_err(o, ro, 4e-3, name)
        check((lse - rl).abs().max().item() <= 1e-3, f"{name} lse")
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                               causal=True)
        for split in (False, True):
            grads = fa._flash_bwd_cuda(q, k, v, o, lse, do, None, None, True,
                                       d ** -0.5, split=split)
            torch.cuda.synchronize()
            errs = []
            for gname, g, r in zip(("dq", "dk", "dv"), grads, ref):
                what = f"{name} {'split' if split else 'single'} {gname}"
                errs.append(_fp32_err(g, r, what, FP32_GRAD_TOL)
                            if dtype == torch.float32
                            else grad_err(g, r, what))
            rec["bwd_split_err" if split else "bwd_err"] = max(errs)
        out.append(rec)
    return out


def check_paged_repairs(torch):
    """Paged decode at GQA group 16 (chunks of 8 rows) in the bf16 and the
    e4m3 pool mode, with fp16 and fp32 queries over pools of their dtype
    and over e4m3, at head dims 80, 96, 100 (masked loads), 256 and 512 in
    both pool modes (the pool read in place), and with queries over a
    pool of another dtype."""
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    out = []
    for dtype, g, pool, d in ((bf, 16, bf, 64), (bf, 16, "e4m3", 64),
                              (f16, 16, f16, 64), (f16, 4, "e4m3", 64),
                              (f32, 16, f32, 64), (f32, 2, "e4m3", 64),
                              (bf, 4, bf, 80), (bf, 4, "e4m3", 80),
                              (bf, 4, bf, 96), (bf, 4, "e4m3", 96),
                              (bf, 4, bf, 100), (f32, 4, "e4m3", 100),
                              (bf, 4, bf, 256), (bf, 4, "e4m3", 256),
                              (bf, 8, bf, 512), (bf, 8, "e4m3", 512),
                              (f32, 4, bf, 64), (bf, 4, f32, 64)):
        fp8 = pool == "e4m3"
        b, kv, page, m, num_pages = 4, 4, 128, 8, 40
        q, kp, vp, bt, sl = _paged_inputs(torch, gen, b, kv, g, d, page, m,
                                          num_pages, [0, 129, 640, 1024])
        q = q.to(dtype)
        ks = vs = None
        if fp8:
            kp, ks = _fp8_pool(torch, gen, kv, num_pages, page, d)
            vp, vs = _fp8_pool(torch, gen, kv, num_pages, page, d)
        else:
            kp, vp = kp.to(pool), vp.to(pool)
        got = fa.paged_decode_attention(q, kp, vp, bt, sl, k_scales=ks,
                                        v_scales=vs)
        ref = fa.paged_attention_reference(q, kp, vp, bt, sl, k_scales=ks,
                                           v_scales=vs)
        torch.cuda.synchronize()
        pname = "e4m3" if fp8 else str(pool)[6:]
        name = f"paged {str(dtype)[6:]} over {pname} d{d} group {g}"
        # p and the accumulators are fp32 in both: the output rounding
        err = (_fp32_err(got, ref, name, FP32_FWD_TOL)
               if dtype == torch.float32 else bf16_err(got, ref, 1e-3, name))
        check(got[0].abs().max().item() == 0.0, f"{name}: dead slot")
        out.append(dict(dtype=str(dtype)[6:], pool=pname, d=d, group=g,
                        max_abs_err=err))
    return out


def check_lm_head_ce_repairs(torch):
    """The LM-head CE forward and backward at other hidden sizes (64: the
    tests' tiny GPT; 100, 1536, 1600, 2048), fp16, and fp32 (the FFMA
    route at h 64, 100, 1024, 1536, 2048 and a ragged 1000 x 1003 x 1601),
    at the GPT's vocabulary, held at the CE limits of PERF.md §2, the fp32
    route's backward bitwise on a rerun."""
    from apex_tpu_torch.ops import lm_head_ce as ce
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = []
    for dtype, h, n, V in ((torch.bfloat16, 64, 1024, 32768),
                           (torch.bfloat16, 100, 1024, 32768),
                           (torch.bfloat16, 1536, 1024, 32768),
                           (torch.bfloat16, 1600, 1024, 32768),
                           (torch.bfloat16, 2048, 1024, 32768),
                           (torch.float16, 1024, 1024, 32768),
                           (torch.float32, 64, 1024, 32768),
                           (torch.float32, 100, 1024, 32768),
                           (torch.float32, 1024, 1024, 32768),
                           (torch.float32, 1536, 1024, 32768),
                           (torch.float32, 2048, 1024, 32768),
                           (torch.float32, 1601, 1000, 1003)):
        x = torch.randn(n, h, generator=gen, device="cuda").to(dtype)
        e = (0.02 * torch.randn(V, h, generator=gen, device="cuda")).to(
            dtype)
        tgt = torch.randint(0, V, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        dl = torch.full((n,), 1.0 / n, device="cuda")
        name = f"lm_head_ce {str(dtype)[6:]} h{h}"
        got = ce.lm_head_ce_fwd(x, e, tgt, True)
        ref = ce.lm_head_ce_fwd_reference(x, e, tgt, True)
        torch.cuda.synchronize()
        fwd = 0.0
        for sname, a, r in zip(("m", "l", "pred", "ssum"), got, ref):
            err = (a - r).abs().max().item()
            check(err <= 1e-4 * (r.abs().max().item() + 1.0),
                  f"{name} fwd {sname} max err {err}")
            fwd = max(fwd, err)
        dx, de = ce.lm_head_ce_bwd(x, e, tgt, ref[0], ref[1], dl, 0.1)
        rx, re = ce.lm_head_ce_bwd_reference(x, e, tgt, ref[0], ref[1], dl,
                                             0.1)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            bwd = max(_fp32_err(dx, rx, f"{name} dx", FP32_GRAD_TOL),
                      _fp32_err(de, re, f"{name} dE", FP32_GRAD_TOL))
            dx2, de2 = ce.lm_head_ce_bwd(x, e, tgt, ref[0], ref[1], dl, 0.1)
            check(torch.equal(dx, dx2) and torch.equal(de, de2),
                  f"{name}: two runs of the backward differ")
        else:
            bwd = max(grad_err(dx, rx, f"{name} dx"),
                      grad_err(de, re, f"{name} dE"))
        hp = ce.f32_hidden(h) if dtype == torch.float32 \
            else ce.wgmma_hidden(h)
        out.append(dict(dtype=str(dtype)[6:], h=h, n=n, V=V, padded_h=hp,
                        fwd_err=fwd, bwd_err=bwd))
    return out


def check_fp8_repairs(torch):
    """The fp8 dequant-matmul at K = N = 1000 (zero-padded to 1008) in the
    decode and the prefill regime."""
    from apex_tpu_torch.ops import fp8_matmul as mm
    gen = torch.Generator(device="cuda").manual_seed(14)
    out = []
    for m in (8, 512):
        K = N = 1000
        x = torch.randn(m, K, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        w = torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5
        q, scale = mm.quantize_weight(w)
        y = mm.fp8_dequant_matmul(x, q, scale)
        ref = mm.fp8_dequant_matmul_reference(x, q, scale)
        torch.cuda.synchronize()
        check(y.shape == (m, N), f"fp8 K=N=1000: shape {tuple(y.shape)}")
        out.append(dict(m=m, K=K, N=N, max_abs_err=bf16_err(
            y, ref, 1e-3, f"fp8_matmul m{m} K{K} N{N}")))
    return out


def check_repairs(torch):
    return dict(flash=check_flash_repairs(torch),
                paged_decode=check_paged_repairs(torch),
                lm_head_ce=check_lm_head_ce_repairs(torch),
                fp8_matmul=check_fp8_repairs(torch))


# ---------------------------------------------------------------------------
# B15, the fused bottleneck, and B14, the per-op probe: kernel phase
# ---------------------------------------------------------------------------

# the fused bottleneck against its plain version, both bf16 with the same
# rounding points: two bf16 ulps plus a floor of 2^-5 — h1 and h2 are
# rounded to bf16 in both, and one h2 value rounded the other way (an fp32
# sum in another order) moves an output by |w3| times its ulp, summed over
# the flips of a pixel
BOTTLENECK_FLOOR = 2.0 ** -5
BOTTLENECK_LIB_TOL = 0.15          # the proto's own limit against XLA


def check_bottleneck(torch, timer):
    from apex_tpu_torch.scripts import bottleneck_proto as bp
    p = bp.make_params(device="cuda")
    x = bp.make_input(bp.N, device="cuda")
    wts = bp.cudnn_weights(p)
    y = bp.fused_block(x, p)
    ref = bp.plain_block(x, p)
    lib = bp.cudnn_block(x, p, wts)
    torch.cuda.synchronize()
    err = bf16_err(y, ref, BOTTLENECK_FLOOR, "bottleneck vs plain")
    lib_err = (y.float() - lib.float()).abs().max().item()
    check(lib_err < BOTTLENECK_LIB_TOL, f"bottleneck vs the cuDNN "
          f"composition: {lib_err} >= {BOTTLENECK_LIB_TOL}")
    check(bool(torch.isfinite(y.float()).all()), "bottleneck: non-finite")
    ms = timer(lambda: bp.fused_block(x, p))
    plain_ms = timer(lambda: bp.plain_block(x, p), iters=10)
    lib_ms = timer(lambda: bp.cudnn_block(x, p, wts))
    px = bp.N * bp.H * bp.W
    flops = 2.0 * px * (bp.C * bp.S + 9 * bp.S * bp.S + bp.S * bp.C)
    nbytes = 2 * px * bp.C * 2 + sum(t.numel() * 2 for t in p.values())
    t_bound, by = bound(flops, nbytes)
    return dict(name="bottleneck", route="cuda",
                source="apex_tpu_torch/csrc/bottleneck.cu",
                replaces="scripts/bottleneck_proto.py:89",
                shape=f"x [{bp.N}, {bp.H}, {bp.W}, {bp.C}] NHWC bf16, "
                      f"squeeze {bp.S}, folded batch norms",
                max_abs_err=err,
                tolerance=f"2 bf16 ulp + {BOTTLENECK_FLOOR} vs plain; < "
                          f"{BOTTLENECK_LIB_TOL} vs the cuDNN composition",
                cudnn_composition_max_abs_err=lib_err,
                ms=ms, plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                library_ms=lib_ms,
                library="three channels_last bf16 F.conv2d with the folded "
                        "batch norms, ReLUs and residual as bf16 "
                        "elementwise ops")


def check_vpu_probe(torch, timer):
    """Each op's one launch against the plain loop on the same [64, 512,
    512] input: mul, max, where, iota_cmp_where bitwise; exp, exp2 within
    2 fp32 ulps (CUDA's expf/exp2f against torch's; read 0). The record's
    times are the six launches' sums, its bound the larger of their bytes
    and their operations summed; ``by_op`` has each op's."""
    from apex_tpu_torch.scripts import vpu_probe as vp
    x = torch.from_numpy(np.random.RandomState(0).randn(
        64, vp.BQ, vp.BK).astype(np.float32)).cuda()
    by_op = {}
    for op in vp.OPS:
        got = vp.vpu_probe_kernel(x, op)
        ref = vp.vpu_probe_reference(x, op)
        torch.cuda.synchronize()
        ulps = (got.view(torch.int32).long()
                - ref.view(torch.int32).long()).abs().max().item()
        check(ulps <= (2 if op in ("exp", "exp2") else 0),
              f"vpu_probe {op}: {ulps} ulps from the plain loop")
        b = vp.bounds(op)
        by_op[op] = dict(max_ulps=ulps,
                         max_abs_err=(got - ref).abs().max().item(),
                         ms=timer(lambda: vp.vpu_probe_kernel(x, op)),
                         plain_ms=timer(lambda: vp.vpu_probe_reference(x, op),
                                        iters=5),
                         bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                         bytes_ms=b["bytes_ms"], ops_ms=b["ops_ms"],
                         issue=b["issue"], rate_per_s=b["rate_per_s"])
        del got, ref
    total = {k: sum(r[k] for r in by_op.values())
             for k in ("ms", "plain_ms", "bytes_ms", "ops_ms")}
    # the six launches' bytes at the HBM rate against their operations at
    # their units' rates (fp32 lanes, or the SFUs for exp and exp2)
    t_bound = max(total["bytes_ms"], total["ops_ms"])
    by = "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations"
    return dict(name="vpu_probe", route="cuda",
                source="apex_tpu_torch/csrc/vpu_probe.cu",
                replaces="scripts/vpu_probe.py:18",
                shape="x [64, 512, 512] fp32, 64 applications; ms, plain_ms "
                      "and bound_ms cover one launch of each of the six ops",
                max_abs_err=max(r["max_abs_err"] for r in by_op.values()),
                tolerance="bitwise (mul, max, where, iota_cmp_where); 2 fp32 "
                          "ulp (exp, exp2)",
                ms=total["ms"], plain_ms=total["plain_ms"],
                bound_ms=t_bound, bound_by=by,
                library_ms=None,
                library="no single PyTorch call applies an op 64 times",
                sm_clock_hz=vp.sm_clock_hz(), by_op=by_op)


# ---------------------------------------------------------------------------
# the new paths: B14's probe, B15 at the proto's shape, SpatialBottleneck at
# world 1, the O0 GPT step
# ---------------------------------------------------------------------------

def run_probe_path(torch):
    """The probe script's run: each of the six ops chained 16 times over
    [64, 512, 512] and summed, timed as the script times it."""
    from apex_tpu_torch.scripts import vpu_probe as vp
    reset_counters()
    res = {op: vp.probe(op) for op in vp.OPS}
    launches = read_counters()
    # probe: one warm-up and five timed windows of scan_len launches
    check(launches["vpu_probe"] == len(vp.OPS) * 6 * 16,
          f"vpu probe path: {launches['vpu_probe']} launches")
    return dict(by_op=res, launches=launches)


def run_bottleneck_path(torch):
    """The proto's run at N = 32: one checked block, then the script's
    timed() of the kernel and of the cuDNN composition."""
    from apex_tpu_torch.scripts import bottleneck_proto as bp
    p = bp.make_params(device="cuda")
    x = bp.make_input(bp.N, device="cuda")
    wts = bp.cudnn_weights(p)
    reset_counters()
    y = bp.fused_block(x, p)
    lib = bp.cudnn_block(x, p, wts)
    torch.cuda.synchronize()
    err = (y.float() - lib.float()).abs().max().item()
    check(err < BOTTLENECK_LIB_TOL, f"bottleneck path: {err} from cuDNN")
    t_fused = bp.timed(bp.fused_block, x, p)
    t_lib = bp.timed(lambda a, b: bp.cudnn_block(a, b, wts), x, p)
    launches = read_counters()
    check(launches["bottleneck"] == 1 + 1 + 5 * 64,
          f"bottleneck path: {launches['bottleneck']} launches")
    return dict(n=bp.N, max_abs_err_vs_cudnn=err, fused_ms=t_fused,
                cudnn_ms=t_lib, speedup=t_lib / t_fused, launches=launches)


SPATIAL_N, SPATIAL_C, SPATIAL_F, SPATIAL_HW, SPATIAL_STEPS = 32, 256, 64, 56, 4
# SpatialBottleneck against models.resnet.Bottleneck with the same weights.
# In fp32 (TF32 off) the two differ only in their batch norms' fp32 sums
# (SyncBatchNorm's own against cuDNN's): the forward within 1e-4 of the
# largest value and in relative norm. A pre-activation that lands within
# those last bits of a ReLU's zero switches the ReLU's mask, and with it
# that element's whole gradient; such flips, a fraction f of the elements,
# put ~sqrt(f) into the gradients' relative norm (read 5.8e-4 for dx at
# 25.7 M elements): the fp32 gradients are held within 2e-3 in relative
# norm with at most 1e-4 of their elements beyond 2^-6 of themselves plus
# 1e-3 of the largest value. In the O2 set-up (bf16 convs, fp32 norms) the
# two batch norms round their bf16 outputs and gradients at other points,
# which flips more roundings and masks: the forward is held within 1 % in
# relative norm with at most 0.1 % of elements beyond two bf16 ulps + 2 %
# of the largest value; the gradients within 10 % in relative norm — this
# block's bf16 gradients are 4-8 % from its fp32 gradients (measured on
# the CPU, N 4 at 14 x 14), so two bf16 implementations agree no closer.
SPATIAL_FP32_TOL = 1e-4
SPATIAL_FP32_GRAD_TOL = 2e-3
SPATIAL_FP32_FAR = 1e-4
TWIN_NORM_TOL = 1e-2
TWIN_FAR_FRAC = 1e-3
TWIN_GRAD_NORM_TOL = 0.1


def _close_twin(got, ref, what, norm_tol, far_frac=None, floor_frac=0.0,
                elem_rel=2.0 ** -6):
    """Relative-norm agreement within ``norm_tol``; with ``far_frac``, at
    most that fraction of elements beyond ``elem_rel`` of themselves
    (2^-6: two bf16 ulps) plus ``floor_frac`` of the largest value."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    rel = (diff.norm() / ref.norm().clamp_min(1e-30)).item()
    check(rel <= norm_tol, f"{what}: relative norm error {rel} > {norm_tol}")
    far = 0.0
    if far_frac is not None:
        tol = ref.abs() * elem_rel + floor_frac * ref.abs().max()
        far = (diff > tol).float().mean().item()
        check(far <= far_frac, f"{what}: {far} of elements beyond {elem_rel} "
              f"of themselves + {floor_frac} of the largest value")
    return dict(max_abs_err=diff.max().item(), rel_norm=rel, frac_far=far)


def _spatial_loss(m, x, t):
    return ((m(x).float() - t) ** 2).mean()


def _spatial_twins(torch, dtype, x, t):
    """SpatialBottleneck and models.resnet.Bottleneck with the same random
    conv weights (seed 15), computing in ``dtype``: forward and backward
    of the loss on (x, t), then their readings against each other."""
    from apex_tpu_torch.contrib.bottleneck import (Bottleneck,
                                                   SpatialBottleneck)
    gen = torch.Generator(device="cuda").manual_seed(15)
    sp = SpatialBottleneck(SPATIAL_C, SPATIAL_F, dtype=dtype, device="cuda")
    ref = Bottleneck(SPATIAL_C, SPATIAL_F, dtype=dtype, device="cuda")
    pairs = (("conv1", sp.conv1, ref.Conv_0), ("conv2", sp.conv2, ref.Conv_1),
             ("conv3", sp.conv3, ref.Conv_2))
    with torch.no_grad():
        for _, w, r in pairs:
            w.copy_(torch.randn(w.shape, generator=gen, device="cuda")
                    * (2.0 / w[0].numel()) ** 0.5)
            r.copy_(w)
    xs, xr = (x.to(dtype).clone().requires_grad_() for _ in range(2))
    ys, yr = sp(xs), ref(xr)
    ((ys.float() - t) ** 2).mean().backward()
    ((yr.float() - t) ** 2).mean().backward()
    torch.cuda.synchronize()
    tag = f"spatial {str(dtype)[6:]}"
    if dtype == torch.float32:
        def grad_check_(g, r, what):
            return _close_twin(g, r, what, SPATIAL_FP32_GRAD_TOL,
                               SPATIAL_FP32_FAR, floor_frac=1e-3)
        fwd = _close_twin(ys, yr, f"{tag} forward", SPATIAL_FP32_TOL, 0.0,
                          floor_frac=SPATIAL_FP32_TOL, elem_rel=0.0)
    else:
        def grad_check_(g, r, what):
            return _close_twin(g, r, what, TWIN_GRAD_NORM_TOL)
        fwd = _close_twin(ys, yr, f"{tag} forward", TWIN_NORM_TOL,
                          TWIN_FAR_FRAC, floor_frac=0.02)
    out = {"y": fwd, "x": grad_check_(xs.grad, xr.grad, f"{tag} dx")}
    for name, w, r in pairs:
        out[name] = grad_check_(w.grad, r.grad, f"{tag} d{name}")
    for pm in sp.parameters():
        pm.grad = None
    return sp, out


def run_spatial_path(torch):
    """SpatialBottleneck at world 1 and ResNet-50's conv2_x width (256 ->
    64 -> 256, 56 x 56, N 32): forward and backward against the port's
    models.resnet.Bottleneck with the same weights (the same function at
    world 1) in fp32 and in the O2 set-up (bf16 convs, fp32 norms), then
    O2 FusedSGD steps."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedSGD
    gen = torch.Generator(device="cuda").manual_seed(16)
    shape = (SPATIAL_N, SPATIAL_C, SPATIAL_HW, SPATIAL_HW)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.randn(shape, generator=gen, device="cuda")
    reset_counters()
    _, fp32 = _spatial_twins(torch, torch.float32, x, t)
    sp, bf16 = _spatial_twins(torch, torch.bfloat16, x, t)
    amp_model, opt = amp.initialize(sp, FusedSGD(lr=0.1, momentum=0.9),
                                    opt_level="O2", verbosity=0)
    amp_model.cast_params()
    check(sp.n1.weight.dtype == torch.float32
          and sp.conv1.dtype == torch.bfloat16, "spatial: O2 cast")
    state = opt.init(sp.parameters())
    step = amp.make_train_step(_spatial_loss, opt)
    sstate = opt._scaler.state
    losses, times = [], []
    for _ in range(SPATIAL_STEPS):
        t0 = time.perf_counter()
        _, state, sstate, loss = step(sp, state, sstate, x, t)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    launches = read_counters()
    check(all(np.isfinite(losses)), f"spatial: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"spatial: loss did not fall {losses}")
    return dict(n=SPATIAL_N, c=SPATIAL_C, filters=SPATIAL_F,
                hw=SPATIAL_HW, against_bottleneck_fp32=fp32,
                against_bottleneck_o2=bf16, losses=losses,
                step_ms_all=times, step_ms_median=float(np.median(times[1:])),
                launches=launches)


O0_LAYERS, O0_B, O0_S, O0_STEPS = 2, 8, 1024, 3
O0_PER_STEP = {**{k: 0 for k in TRAIN_PER_STEP}, "flash_fwd": O0_LAYERS,
               "flash_bwd": O0_LAYERS, "layer_norm_fwd": 2 * O0_LAYERS + 1,
               "layer_norm_bwd": 2 * O0_LAYERS + 1, "lm_head_ce_fwd_f32": 1,
               "lm_head_ce_bwd_f32": 1}
# the O0 step against GPT.loss(reference=True), both fp32 on the same
# parameters: the kernels round nothing below fp32 (p, ds and the CE
# gradient tile stay fp32), so only summation order and __expf differ
O0_LOSS_TOL = 1e-5
O0_GRAD_TOL = 1e-4


def run_o0_path(torch):
    """An O0 (fp32) GPT training step through the kernels: 2 layers at
    full width (h1024, 16 heads, V32768), b8 s1024, FusedAdam through
    amp.make_train_step; then the loss and every gradient against the
    plain versions differentiated by autograd."""
    import dataclasses
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import GPT
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = dataclasses.replace(gpt_config(), num_layers=O0_LAYERS,
                              dtype=torch.float32)
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    ids, labels = train_batch(torch, cfg, O0_B, O0_S)
    params = list(model.named_parameters())
    loss = model.loss(ids, labels)
    grads = torch.autograd.grad(loss, [p for _, p in params])
    ref_loss = model.loss(ids, labels, reference=True)
    ref = torch.autograd.grad(ref_loss, [p for _, p in params])
    loss, ref_loss = loss.detach(), ref_loss.detach()
    dloss = abs(float(loss) - float(ref_loss))
    check(dloss <= O0_LOSS_TOL * abs(float(ref_loss)),
          f"O0 loss kernels {float(loss)} vs plain {float(ref_loss)}")
    worst = []
    for (name, _), g, r in zip(params, grads, ref):
        rel = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
        worst.append((rel, name))
        check(rel <= O0_GRAD_TOL, f"O0 grad {name}: relative norm {rel}")
    worst.sort(reverse=True)
    del grads, ref
    amp_model, opt = amp.initialize(model, FusedAdam(lr=LR), opt_level="O0",
                                    verbosity=0)
    amp_model.cast_params()
    state = opt.init(model.parameters())
    step = amp.make_train_step(lambda m, i, l: m.loss(i, l), opt)
    sstate = opt._scaler.state
    _, state, sstate, _ = step(model, state, sstate, ids, labels)
    torch.cuda.synchronize()
    reset_counters()
    losses, times = [], []
    for _ in range(O0_STEPS):
        t0 = time.perf_counter()
        _, state, sstate, l_ = step(model, state, sstate, ids, labels)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(l_))
    launches = read_counters()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"O0 losses {losses}")
    for k, per in O0_PER_STEP.items():
        check(launches[k] == per * O0_STEPS,
              f"O0 {k}: {launches[k]} launches, expected {per * O0_STEPS}")
    box = [state, sstate]

    def one():
        _, box[0], box[1], _ = step(model, box[0], box[1], ids, labels)

    # one more step under torch.profiler: device time by kernel class
    trace_one = _profile(torch, one, 1)
    return dict(layers=O0_LAYERS, batch=O0_B, seq=O0_S, dtype="float32",
                trace=trace_one,
                loss_kernels=float(loss), loss_plain=float(ref_loss),
                loss_abs_diff=dloss, worst_grad_rel_norm=worst[:5],
                median_grad_rel_norm=float(np.median([w for w, _ in worst])),
                losses=losses, step_ms_all=times,
                step_ms_median=float(np.median(times)),
                tokens_per_s=O0_B * O0_S / (np.median(times) / 1e3),
                launches=launches)


O0_LONG_S, O0_LONG_B, O0_LONG_STEPS = 4096, 2, 2
# fp32 past the gate: the split on flash_bwd.cu's route
O0_LONG_PER_STEP = {**O0_PER_STEP, "flash_bwd": 0,
                    "flash_bwd_dkdv": O0_LAYERS, "flash_bwd_dq": O0_LAYERS}


def run_o0_long_path(torch):
    """The O0 GPT (2 layers at full width, fp32) at b2 s4096, past the
    flash backward's gate: a warm-up, then 2 counted ``FusedAdam`` steps
    through ``amp.make_train_step``, every split launch on flash_bwd.cu's
    route (fp32 takes no wgmma)."""
    import dataclasses
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import GPT
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = dataclasses.replace(gpt_config(max_seq_len=O0_LONG_S),
                              num_layers=O0_LAYERS, dtype=torch.float32)
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    ids, labels = train_batch(torch, cfg, O0_LONG_B, O0_LONG_S)
    amp_model, opt = amp.initialize(model, FusedAdam(lr=LR), opt_level="O0",
                                    verbosity=0)
    amp_model.cast_params()
    state = opt.init(model.parameters())
    step = amp.make_train_step(lambda m, i, l: m.loss(i, l), opt)
    sstate = opt._scaler.state
    _, state, sstate, _ = step(model, state, sstate, ids, labels)
    torch.cuda.synchronize()
    reset_counters()
    losses, times = [], []
    for _ in range(O0_LONG_STEPS):
        t0 = time.perf_counter()
        _, state, sstate, l_ = step(model, state, sstate, ids, labels)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(l_))
    launches = read_counters()
    check(all(np.isfinite(losses)), f"O0 s{O0_LONG_S} losses {losses}")
    for k, per in O0_LONG_PER_STEP.items():
        check(launches[k] == per * O0_LONG_STEPS,
              f"O0 s{O0_LONG_S} {k}: {launches[k]} launches, expected "
              f"{per * O0_LONG_STEPS}")
    return dict(layers=O0_LAYERS, batch=O0_LONG_B, seq=O0_LONG_S,
                dtype="float32", losses=losses, step_ms_all=times,
                step_ms_median=float(np.median(times)), launches=launches)


# ---------------------------------------------------------------------------
# ZeRO-3 O2 training of the same GPT (world 1: one card), and tier 2 with
# DistributedFusedLAMB
# ---------------------------------------------------------------------------

ZERO_WD = 0.01
ZERO_PER_STEP = {**TRAIN_PER_STEP, "multi_tensor_update": 1}
DFLAMB_STEPS, DFLAMB_LR = 3, 1e-3
DFLAMB_PER_STEP = {**TRAIN_PER_STEP, "multi_tensor_update_lamb": 1}


def zero3_setup(torch, cfg):
    """The JAX flow (``amp/frontend.py:156-190``, ``zero/step.py``):
    amp.initialize(model, ZeroOptimizer(adam, shard_params=True), O2,
    zero=True) -> shard the fp32 params -> opt.init -> cast_params ->
    zero.make_train_step over GPT.loss. Random weights from seed 0."""
    from apex_tpu_torch import amp, zero
    from apex_tpu_torch.models.gpt import GPT
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    zm, opt = amp.initialize(
        model, zero.ZeroOptimizer(lr=LR, kind="adam", shard_params=True,
                                  weight_decay=ZERO_WD),
        opt_level="O2", loss_scale="dynamic", verbosity=0, zero=True)
    shards32 = zm.shard()
    state = opt.init(shards32, zm.spec)
    shards = zm.cast_params(shards32)
    del shards32
    check({x.dtype for x in shards.values()} == {torch.bfloat16},
          "ZeRO-3 O2: resident shards are not all bf16")
    step = zero.make_train_step(lambda m, i, l: m.loss(i, l), optimizer=opt)
    return model, zm, opt, shards, state, step


def dense_twin(torch, cfg, ids, labels):
    """The dense FusedAdam O2 step of the train path from the same fp32
    init (its masters taken before the cast, as ZeroOptimizer takes them)
    on the same batch: yields the state after each step."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import GPT
    from apex_tpu_torch.optimizers import FusedAdam
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    amp_model, opt = amp.initialize(model, FusedAdam(lr=LR,
                                                     weight_decay=ZERO_WD),
                                    opt_level="O2", loss_scale="dynamic",
                                    verbosity=0)
    state = opt.init(model.parameters())
    amp_model.cast_params()
    step = amp.make_train_step(lambda m, i, l: m.loss(i, l), opt)
    sstate = opt._scaler.state
    while True:
        _, state, sstate, _ = step(model, state, sstate, ids, labels)
        torch.cuda.synchronize()
        yield model, opt, state, sstate


def zero3_phases(torch, zm, opt, shards, state, sstate, ids, labels,
                 reps=3):
    """Device time of each phase of the ZeRO-3 step by CUDA events, the
    functions ``zero.make_train_step`` calls one by one in its order:
    materialize + forward + backward, unscale, the flag, the optimizer
    (one B13 launch plus the cast into the bf16 shards), the scaler."""
    from apex_tpu_torch.amp import scaler as scaler_mod
    names = ("forward_backward", "unscale", "inf_flag", "optimizer",
             "scaler_update")
    ms = {k: [] for k in names}
    floats = list(zm.spec.names)
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        torch.cuda.synchronize()
        ev[0].record()
        leaves = {k: x.detach().requires_grad_() for k, x in shards.items()}
        loss = zm.call(zm.materialize(leaves), lambda m, i, l: m.loss(i, l),
                       ids, labels)
        grads = torch.autograd.grad(scaler_mod.scale_value(loss, sstate),
                                    [leaves[k] for k in floats])
        ev[1].record()
        g32, found_inf = scaler_mod.unscale(grads, sstate)
        del grads, leaves
        ev[2].record()
        found_inf = found_inf.to(torch.int32) > 0
        ev[3].record()
        shards, state = opt.apply(state, shards, g32, skip=found_inf,
                                  spec=zm.spec)
        ev[4].record()
        sstate = opt._scaler.update_state(sstate, found_inf)
        ev[5].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            ms[k].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: float(np.median(v)) for k, v in ms.items()}, shards, state, \
        sstate


# ZeRO-3 masters, m and v against the dense FusedAdam twin's: both run the
# same kernels on the same batch from the same fp32 masters (bitwise on the
# CPU, tests/test_torch_zero.py), so on the card they may differ only where
# a gradient is summed in another order in the two steps and a bf16
# rounding flips. Adam moves a master by ~lr a step whatever
# its gradient's size, so a flipped near-zero gradient can put two masters
# up to 2 * lr apart a step (the first step moves each by lr * g / (|g| +
# eps), at most lr: read 5.99e-4 against 6e-4 on the H100), plus the
# masters' own roundings, ZERO_TWIN_ULPS (an fp32 ulp of values up to 8).
# After one step the moments are 0.1 g and 0.001 g^2: they differ as the
# gradients do; after nine steps every gradient differs a little (the
# masters already do), read at 1.7-2.6 % (m) and 1.5-2.2 % (v) in
# relative norm on the H100 (PERF.md)
ZERO_TWIN_FAR_FRAC = 0.01
ZERO_TWIN_ULPS = 1e-6
ZERO_TWIN_SLOT_REL_1, ZERO_TWIN_SLOT_REL = 1e-2, 5e-2


def _zero3_twin_check(torch, st, dstate, steps):
    """``st``: ``(master, m, v)`` flat buffers of the ZeRO-3 state after
    ``steps`` steps, ``dstate`` the twin's after as many."""
    g = dstate.groups[0]
    out = {}
    for name, a, r in (("master", st[0], g.master),
                       ("m", st[1], g.slots["exp_avg"]),
                       ("v", st[2], g.slots["exp_avg_sq"])):
        a = a.to(r.device)
        d = (a - r).abs()
        out[name] = dict(bitwise=bool(torch.equal(a, r)),
                         max_abs_diff=d.max().item(),
                         rel_norm=(d.norm() / r.norm().clamp_min(1e-30))
                         .item(),
                         frac_differing=(d > 0).float().mean().item())
        if name == "master":
            out[name]["frac_over_half_lr"] = (d > LR / 2).float().mean()\
                .item()
        del d
    log(f"train-zero3 vs dense FusedAdam twin after {steps} steps: "
        + json.dumps(out))
    check(out["master"]["max_abs_diff"] <= 2 * LR * steps + ZERO_TWIN_ULPS,
          f"ZeRO-3 masters beyond 2 * lr * steps of the dense twin's: {out}")
    check(out["master"]["frac_over_half_lr"] <= ZERO_TWIN_FAR_FRAC,
          f"ZeRO-3 masters: too many far from the dense twin's: {out}")
    for k in ("m", "v"):
        limit = ZERO_TWIN_SLOT_REL_1 if steps == 1 else ZERO_TWIN_SLOT_REL
        check(out[k]["rel_norm"] <= limit,
              f"ZeRO-3 {k}: relative norm {out[k]['rel_norm']} from the "
              f"dense twin's after {steps} steps")
    return out


def run_zero3_path(torch, cfg):
    model, zm, opt, shards, state, step = zero3_setup(torch, cfg)
    ids, labels = train_batch(torch, cfg)
    sstate = opt._scaler.state
    shards, state, sstate, _ = step(shards, state, sstate, ids, labels)
    torch.cuda.synchronize()
    # kept on the host, out of the timed steps' peak device memory
    first = (state.master.flat.cpu(), state.m.flat.cpu(),
             state.v.flat.cpu())
    scale0 = float(sstate.loss_scale)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_counters()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        shards, state, sstate, loss = step(shards, state, sstate, ids,
                                           labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite ZeRO-3 loss: {losses}")
    check(losses[-1] < losses[0], f"ZeRO-3 loss did not fall: {losses}")
    check(float(sstate.loss_scale) == scale0 == 2.0 ** 16,
          "ZeRO-3: the loss scale moved during the timed steps")
    check(int(state.step) == TRAIN_STEPS + 1, "ZeRO-3 step counter")
    for k, per in ZERO_PER_STEP.items():
        check(launches[k] == per * TRAIN_STEPS,
              f"train-zero3 {k}: {launches[k]} launches, expected "
              f"{per * TRAIN_STEPS}")
    ms = [1e3 * t for t in times]
    stats = dict(steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S, world=1,
                 leaves=len(zm.spec.names),
                 flat_elements=int(state.master.flat.numel()),
                 losses=losses, step_ms_median=float(np.median(ms)),
                 step_ms_p90=float(np.percentile(ms, 90)), step_ms_all=ms,
                 tokens_per_s=TRAIN_B * TRAIN_S / (np.median(ms) / 1e3),
                 peak_mem_gb=peak, launches=launches)
    # the dense twin from the same init: after the warm-up step, then after
    # the same 1 + 8 steps
    twin = dense_twin(torch, cfg, ids, labels)
    dmodel, dopt, dstate, dss = next(twin)
    stats["twin_after_1_step"] = _zero3_twin_check(torch, first, dstate, 1)
    del first
    for _ in range(TRAIN_STEPS):
        dmodel, dopt, dstate, dss = next(twin)
    del twin
    stats["twin"] = _zero3_twin_check(
        torch, (state.master.flat, state.m.flat, state.v.flat), dstate,
        TRAIN_STEPS + 1)
    box = [shards, state, sstate]

    def one():
        box[0], box[1], box[2], _ = step(box[0], box[1], box[2], ids,
                                         labels)

    trace_z = _profile(torch, one, 2)
    phases, shards, state, sstate = zero3_phases(
        torch, zm, opt, box[0], box[1], box[2], ids, labels)
    dphases, _, _ = step_phases(torch, cfg, dmodel, dopt, dstate, dss)
    stats["phases_ms"] = phases
    stats["dense_fused_adam_phases_ms"] = dphases
    del dmodel, dopt, dstate, dss
    torch.cuda.empty_cache()
    stats["overflow"] = zero3_overflow_check(torch, cfg, opt, shards, state,
                                             sstate, ids, labels)
    return stats, trace_z


def zero3_overflow_check(torch, cfg, opt, shards, state, sstate, ids,
                         labels):
    """A step whose loss overflows: resident shards, masters, m, v and the
    step bitwise unchanged (the kernel writes nothing under the flag), the
    scale halved."""
    from apex_tpu_torch import zero
    big = zero.make_train_step(lambda m, i, l: m.loss(i, l) * 1e38,
                               optimizer=opt)
    before = ({k: v.clone() for k, v in shards.items()},
              state.master.flat.clone(), state.m.flat.clone(),
              state.v.flat.clone(), int(state.step))
    scale0 = float(sstate.loss_scale)
    shards2, state2, sstate2, loss = big(shards, state, sstate, ids, labels)
    torch.cuda.synchronize()
    check(all(torch.equal(shards2[k], v) for k, v in before[0].items()),
          "ZeRO-3 overflow: a resident shard changed")
    check(torch.equal(state2.master.flat, before[1]),
          "ZeRO-3 overflow: master changed")
    check(torch.equal(state2.m.flat, before[2]), "ZeRO-3 overflow: m changed")
    check(torch.equal(state2.v.flat, before[3]), "ZeRO-3 overflow: v changed")
    check(int(state2.step) == before[4], "ZeRO-3 overflow: step moved")
    check(bool(sstate2.overflow), "ZeRO-3 overflow: not detected")
    check(float(sstate2.loss_scale) == scale0 / 2,
          "ZeRO-3 overflow: scale not halved")
    return dict(loss=float(loss), scale_before=scale0,
                scale_after=float(sstate2.loss_scale), step=int(state2.step))


# tier-2 LAMB on the card against its plain twin on the CPU, one step from
# the same state and gradient: the global grad norm and the per-leaf norms
# are fp32 sums in other orders on the two devices, and torch's CPU sqrt
# is not always correctly rounded, so every buffer is held within 1e-5 of
# its largest value
DFLAMB_TWIN_REL = 1e-5


def run_dflamb_path(torch, cfg):
    """Tier 2: ``DistributedFusedLAMB(lr=1e-3, weight_decay=0.01,
    max_grad_norm=1.0)`` through ``amp.initialize`` at O2 and
    ``amp.make_train_step`` on the same GPT; a warm-up, 3 counted steps,
    then one more step on the card (its optimizer phase timed by CUDA
    events) against the CPU twin."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp import scaler as scaler_mod
    from apex_tpu_torch.contrib.optimizers import DistributedFusedLAMB
    from apex_tpu_torch.models.gpt import GPT
    hyper = dict(lr=DFLAMB_LR, weight_decay=0.01, max_grad_norm=1.0)
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    amp_model, opt = amp.initialize(model, DistributedFusedLAMB(**hyper),
                                    opt_level="O2", loss_scale="dynamic",
                                    verbosity=0)
    amp_model.cast_params()
    state = opt.init(model)
    step = amp.make_train_step(lambda m, i, l: m.loss(i, l), opt)
    ids, labels = train_batch(torch, cfg)
    sstate = opt._scaler.state
    _, state, sstate, _ = step(model, state, sstate, ids, labels)  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    losses, times = [], []
    for _ in range(DFLAMB_STEPS):
        t0 = time.perf_counter()
        _, state, sstate, loss = step(model, state, sstate, ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_counters()
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite LAMB loss: {losses}")
    for k, per in DFLAMB_PER_STEP.items():
        check(launches[k] == per * DFLAMB_STEPS,
              f"train-dflamb {k}: {launches[k]} launches, expected "
              f"{per * DFLAMB_STEPS}")
    # one more step's gradient, applied on the card and by the CPU twin
    params = opt.param_groups[0]["params"]
    loss = model.loss(ids, labels)
    grads = torch.autograd.grad(scaler_mod.scale_value(loss, sstate),
                                params)
    g32, found_inf = scaler_mod.unscale(list(grads), sstate)
    del grads
    twin = DistributedFusedLAMB(**hyper)
    cpu_params = [p.detach().cpu() for p in params]
    twin.init(cpu_params)
    cpu_state = type(state)(*(t.cpu() for t in state))
    cpu_state = twin.apply_flat(cpu_state, g32.cpu(), skip=found_inf.cpu())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    state = opt.apply_flat(state, g32, skip=found_inf)
    ev[1].record()
    torch.cuda.synchronize()
    optimizer_ms = ev[0].elapsed_time(ev[1])
    errs = {}
    for name, a, r in (("master", state.master_shard, cpu_state.master_shard),
                       ("m", state.m_shard, cpu_state.m_shard),
                       ("v", state.v_shard, cpu_state.v_shard)):
        a = a.cpu()
        errs[name] = (a - r).abs().max().item() / max(r.abs().max().item(),
                                                      1e-30)
        check(errs[name] <= DFLAMB_TWIN_REL,
              f"tier-2 LAMB {name} vs the CPU twin: {errs[name]} of max")
    check(int(state.step) == int(cpu_state.step) == DFLAMB_STEPS + 2,
          "tier-2 LAMB step counter")
    ms = [1e3 * t for t in times]
    return dict(steps=DFLAMB_STEPS, batch=TRAIN_B, seq=TRAIN_S, losses=losses,
                step_ms_all=ms, step_ms_median=float(np.median(ms)),
                optimizer_ms=optimizer_ms, twin_rel_err_of_max=errs,
                launches=launches)


_PORT_KERNELS = ("flash_fwd_kernel", "flash_bwd_kernel", "flash_dkdv_kernel",
                 "flash_dq_kernel", "flash_fwd_sm90", "flash_bwd_fused_sm90",
                 "flash_dkdv_sm90", "flash_dq_sm90",
                 "paged_decode_kernel",
                 "_ln_fwd_body", "_ln_bwd_body", "_ce_fwd_body",
                 "_ce_bwd_body", "ce32_fwd_kernel", "ce32_grad_kernel",
                 "ce32_product_kernel", "ce32_transpose_kernel", "FwdEpi",
                 "GradEpi", "DxEpi", "DeEpi",
                 "fp8_mm_decode_kernel", "fp8_mm_tc_kernel", "mtu_kernel")


def _kernel_class(name: str) -> str:
    """The port's own kernels by name; library GEMMs (cuBLAS's nvjet and
    CUTLASS/xmma kernels); memory copies; everything else (PyTorch's
    elementwise, reduction, index and copy kernels)."""
    for k in _PORT_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if any(t in low for t in ("fprop", "dgrad", "wgrad", "conv")):
        return "library conv"
    if "batch_norm" in low or "batchnorm" in low or "bn_fw" in low \
            or "bn_bw" in low:
        return "library batch norm"
    if any(t in low for t in ("nvjet", "gemm", "xmma", "cutlass")):
        return "library GEMM"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "memcpy/memset"
    return "other PyTorch kernels"


def _profile(torch, fn, reps):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    by_class = {}
    for e in kern:
        by_class.setdefault(_kernel_class(e.key), [0.0, 0])
        by_class[_kernel_class(e.key)][0] += e.self_device_time_total
        by_class[_kernel_class(e.key)][1] += e.count
    return dict(
        wall_ms_per_call=wall_us / reps / 1e3,
        device_ms_per_call=dev_us / reps / 1e3,
        device_busy_share=(dev_us / wall_us) if dev_us else None,
        kernel_launches_per_call=sum(e.count for e in kern) / reps,
        device_ms_and_launches_by_class_per_call={
            k: (us / reps / 1e3, n / reps) for k, (us, n) in
            sorted(by_class.items(), key=lambda kv: -kv[1][0])},
        top_device_ms_per_call=[
            (e.key[:60], e.self_device_time_total / reps / 1e3)
            for e in top])


def trace_train(torch, cfg, model, state, sstate, step):
    """torch.profiler over 2 train steps (after one unprofiled); returns
    the trace and the state after them."""
    ids, labels = train_batch(torch, cfg)
    box = [state, sstate]

    def one():
        _, box[0], box[1], _ = step(model, box[0], box[1], ids, labels)

    return _profile(torch, one, 2), box[0], box[1]


def trace(torch, cfg, params, path="serve"):
    """torch.profiler over 4 steady decode steps at batch 8 (under
    speculation a step is one draft-and-verify round for each of the 8
    sequences) and over two prefills of the engine of ``path``: device time
    by kernel and the device-busy share of the wall time (``None`` when the
    profiler records no device time)."""
    from apex_tpu_torch.serve import model as model_mod
    eng = make_engine(cfg, params, **SERVE_PATHS[path])
    rng = np.random.RandomState(1)
    new = 64 if eng.spec_k else 16      # rounds take up to k + 1 tokens
    for _ in range(eng.max_batch):
        eng.add_request(rng.randint(0, cfg.vocab_size, size=256).tolist(),
                        new)
    eng.step()                          # 8 prefills + the first decode
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=512)).cuda()
    # pages of its own for the extra prefill (400 live tokens)
    bt = torch.tensor(eng.sched.allocator.alloc(4), dtype=torch.int32,
                      device="cuda")

    def prefill():
        with torch.no_grad():
            model_mod.prefill_forward(cfg, eng.ccfg, eng.params, eng.state,
                                      bt, 400, ids)

    return {f"{path} decode_step_b8": _profile(torch, eng.step, 4),
            f"{path} prefill_512": _profile(torch, prefill, 2)}


def hgmma_counts(build):
    """``HGMMA`` instructions in the SASS of each wgmma library
    (``cuobjdump -sass``): the LM-head CE's and the flash forward's and
    backward's bf16/fp16 kernels run on the tensor cores' warpgroup
    products or the check fails."""
    out = {}
    for name in build.targets(["lm_head_ce_sm90", "flash_fwd_sm90",
                               "flash_bwd_sm90"]):
        sass = subprocess.run(
            [os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump"),
             "-sass", str(build.library_path(name))], capture_output=True,
            text=True, timeout=300, check=True).stdout
        out[name] = sum("HGMMA" in line for line in sass.splitlines())
        check(out[name] > 0, f"{name}: no HGMMA in its SASS")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from apex_tpu_torch.models.gpt import GPT
    from apex_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    sources = ["flash_fwd", "flash_fwd_sm90", "paged_decode", "flash_bwd",
               "flash_bwd_sm90",
               "lm_head_ce", "lm_head_ce_sm90", "fp8_matmul",
               "multi_tensor_update", "bottleneck", "vpu_probe"]
    sources = _build.targets(sources)       # the dtype-split sources
    _build.build_all(sources)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name in sources:
        text = _build.library_path(name).with_suffix(".log").read_text()
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "setmaxnreg" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log("wgmma in the LM-head CE and flash libraries: "
        + json.dumps(hgmma_counts(_build)))

    log("e4m3 cast, card against CPU: " + json.dumps(check_e4m3_cast(torch)))
    timer = Timer(torch)
    kernels = [*check_flash(torch, timer), check_paged(torch, timer),
               check_paged_fp8(torch, timer), check_fp8_matmul(torch, timer),
               check_layer_norm(torch, timer),
               *check_flash_bwd(torch, timer),
               check_layer_norm_bwd(torch, timer),
               *check_lm_head_ce(torch, timer),
               *check_lm_head_ce_f32(torch, timer),
               *check_flash_split(torch, timer),
               *check_xentropy(torch, timer),
               check_multi_tensor_update(torch, timer),
               check_vpu_probe(torch, timer), check_bottleneck(torch, timer)]
    for kr in kernels:
        log(f"kernel {kr['name']}: err {kr['max_abs_err']:.3g} "
            f"ms {kr['ms']:.4f} plain {kr['plain_ms']:.4f} "
            f"bound {kr['bound_ms']:.4f} ({kr['bound_by']}) "
            f"library {kr['library_ms']}")
        for extra in ("device_launches_per_call", "split_ms", "tflops",
                      "single_pass_ms", "b8_s1024", "registers",
                      "as_called_ms", "ms_by_block_rows", "long_shape",
                      "delta_fold_max_abs_err", "by_shape",
                      "train_shape", "lamb_ms", "checked", "by_op",
                      "cudnn_composition_max_abs_err"):
            if extra in kr:
                log(f"  {kr['name']} {extra}: {json.dumps(kr[extra])}")
    del timer
    log("repaired shapes and dtypes (ROADMAP §C): "
        + json.dumps(check_repairs(torch)))
    torch.cuda.empty_cache()

    cfg = gpt_config()
    t0 = time.perf_counter()
    params = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    log(f"params: {time.perf_counter() - t0:.1f} s")
    serve_stats = {}

    eng, ids, _, stats = run_serve_path(torch, cfg, params, "serve")
    serve_stats["serve"] = stats
    log(f"serve path ({card}): " + json.dumps(stats))
    tf = teacher_forced(torch, cfg, params, eng, ids)
    log("teacher-forced: " + json.dumps(tf) + f" (tolerance {TF_TOL}, "
        f"near-tie margin {TF_TIE})")
    check(tf["max_abs_diff"] <= TF_TOL,
          f"teacher-forced logits differ by {tf['max_abs_diff']}")
    check(tf["worst_flip_gap"] <= TF_TIE,
          f"argmax flip with plain gap {tf['worst_flip_gap']}")
    del eng

    eng, ids, _, stats = run_serve_path(torch, cfg, params, "serve-fp8")
    stats["pool_bytes_bf16_engine"] = serve_stats["serve"]["pool_bytes"]
    serve_stats["serve-fp8"] = stats
    log(f"serve-fp8 path ({card}): " + json.dumps(stats))
    tf8 = teacher_forced(torch, cfg, eng.params, eng, ids)
    tol8 = TF_FP8_FRAC * max(tf8["max_abs_logit"], 1.0)
    log("serve-fp8 teacher-forced, plain forward over the same e4m3 "
        f"weights: {json.dumps(tf8)} (tolerance {TF_FP8_FRAC} x max|logit| "
        f"= {tol8})")
    check(tf8["max_abs_diff"] <= tol8,
          f"serve-fp8 teacher-forced logits differ by {tf8['max_abs_diff']}")
    del eng

    spec, ids, out, stats = run_serve_path(torch, cfg, params,
                                           "serve-spec-fp8w")
    stats["pool_bytes_bf16_engine"] = serve_stats["serve"]["pool_bytes"]
    serve_stats["serve-spec-fp8w"] = stats
    log(f"serve-spec-fp8w path ({card}): " + json.dumps(stats))
    ident = spec_identity(torch, cfg, params, spec, ids, out)
    log("serve-spec-fp8w against a plain fp8-weights engine: "
        + json.dumps(ident))
    check(ident["first_token_divergence"] is None,
          f"speculative tokens differ from plain decode: {ident}")
    check(ident["logits_rows_compared"] > 0 and
          ident["logits_rows_bitwise_equal"] == ident["logits_rows_compared"],
          f"speculative logits rows differ from plain decode: {ident}")
    del spec
    torch.cuda.empty_cache()

    serve_trace = {**trace(torch, cfg, params, "serve"),
                   **trace(torch, cfg, params, "serve-fp8"),
                   **trace(torch, cfg, params, "serve-spec-fp8w")}
    log(f"serve decode step, device against wall time (trace, {card}): "
        + json.dumps({path: {k: serve_trace[f"{path} decode_step_b8"][k]
                             for k in ("device_ms_per_call",
                                       "wall_ms_per_call",
                                       "device_busy_share",
                                       "kernel_launches_per_call")}
                      for path in SERVE_PATHS}))
    del params
    torch.cuda.empty_cache()

    model, opt, state, sstate, step, tstats = run_train_path(torch, cfg)
    log(f"train path ({card}): " + json.dumps(tstats))
    train_trace, state, sstate = trace_train(torch, cfg, model, state,
                                             sstate, step)
    phases, state, sstate = step_phases(torch, cfg, model, opt, state,
                                        sstate)
    log(f"train step phases, device ms ({card}): " + json.dumps(phases))
    log("overflow: " + json.dumps(overflow_check(torch, cfg, model, opt,
                                                 state, sstate)))
    del model, opt, state, sstate, step
    torch.cuda.empty_cache()
    log("grad check (kernels vs plain, tolerances: loss "
        f"{GRAD_LOSS_TOL}, relative norm {GRAD_NORM_TOL}): "
        + json.dumps(grad_check(torch, cfg)))
    torch.cuda.empty_cache()

    long_stats, long_trace = run_long_seq_path(torch)
    log(f"train-gpt-s{LONG_S} path ({card}): " + json.dumps(long_stats))
    torch.cuda.empty_cache()

    model, amp_model, opt, state, rn_stats, rn_trace = run_rn50_path(torch)
    log(f"train-rn50 path ({card}): " + json.dumps(rn_stats))
    log("train-rn50 overflow: " + json.dumps(rn50_overflow_check(
        torch, model, amp_model, opt, state)))
    log("train-rn50 grad check (kernels vs plain twin, tolerances: loss "
        f"{RN_LOSS_TOL}, relative norm {RN_GRAD_NORM_TOL}, median "
        f"{RN_GRAD_MEDIAN_TOL}): "
        + json.dumps(rn50_grad_check(torch, model, amp_model)))
    del model, amp_model, opt, state
    torch.cuda.empty_cache()
    zero_stats, zero_trace = run_zero3_path(torch, cfg)
    log(f"train-zero3 path ({card}): " + json.dumps(zero_stats))
    torch.cuda.empty_cache()
    lamb_stats = run_dflamb_path(torch, cfg)
    log(f"train-dflamb path ({card}): " + json.dumps(lamb_stats))
    torch.cuda.empty_cache()
    new_paths = {}
    for path, run in (("vpu-probe", run_probe_path),
                      ("bottleneck-b32", run_bottleneck_path),
                      ("spatial-bottleneck-b32", run_spatial_path),
                      ("train-o0-gpt2", run_o0_path),
                      (f"train-o0-gpt2-s{O0_LONG_S}", run_o0_long_path)):
        new_paths[path] = run(torch)
        log(f"{path} path ({card}): " + json.dumps(new_paths[path]))
        torch.cuda.empty_cache()
    log("trace: " + json.dumps({**serve_trace, "train_step": train_trace,
                                f"train_step_s{LONG_S}": long_trace,
                                "train_step_rn50": rn_trace,
                                "train_step_zero3": zero_trace}))

    for kr in kernels:
        by_path = {path: st["launches"][kr["name"]]
                   for path, st in serve_stats.items()}
        by_path["train"] = tstats["launches"][kr["name"]]
        by_path[f"train-gpt-s{LONG_S}"] = long_stats["launches"][kr["name"]]
        by_path["train-rn50"] = rn_stats["launches"][kr["name"]]
        by_path["train-zero3"] = zero_stats["launches"][kr["name"]]
        by_path["train-dflamb"] = lamb_stats["launches"][kr["name"]]
        for path, st in new_paths.items():
            by_path[path] = st["launches"][kr["name"]]
        if kr["name"] == "multi_tensor_update":     # its LAMB mode too
            by_path["train-dflamb"] += lamb_stats["launches"][
                "multi_tensor_update_lamb"]
        kr["launches"] = sum(by_path.values())
        kr["launches_by_path"] = by_path
        check(kr["launches"] > 0, f"{kr['name']} never launched on a main "
              "path")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
