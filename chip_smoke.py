#!/usr/bin/env python3
"""Drive ``apex_tpu_torch`` on one NVIDIA GPU and hold its kernels against
their plain PyTorch versions.

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
(``/usr/local/cuda``) and ``triton``::

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is caught):

1. set-up — build the CUDA kernels from ``apex_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together), turn TF32 off, print the card's
   name and power limit;
2. kernels — each kernel's wrapper at the serve path's shapes against its
   plain version on the same inputs, with the tolerance stated beside each
   check, timed with CUDA events (L2 flushed before every launch) beside
   its plain version, a PyTorch library call where one computes the same
   function, and its bound (the least time for its bytes at 3.35 TB/s or
   its operations at 989 TFLOP/s bf16, whichever is larger);
3. main path — ``ServeEngine`` serves 16 requests (prompts of 64-512
   tokens, 64 new tokens each) through the 12-layer h1024 GPT
   (``bench.py``'s ``_bench_gpt`` shape, random weights from seed 0) with
   the launch counters reset just before; asserts every request's length,
   that every page went back, and that each kernel launched the expected
   number of times; prints prefill and decode times;
4. teacher-forced check — for two finished requests, the no-cache forward
   through the plain versions of every kernel, over prompt + generated
   tokens, against the engine's recorded logits.

The second-last line of standard output is the card as ``nvidia-smi``
names it, the line before it the kernels' JSON record, and the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

FLUSH_BYTES = 256 << 20          # > the H100's 50 MB L2
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor cores, data sheet


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


def bound(flops: float, nbytes: float):
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


class Timer:
    """Median milliseconds of ``fn`` over ``iters`` launches, each timed by
    its own CUDA events after an L2 flush."""

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

def check_flash(torch, timer):
    import torch.nn.functional as F
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    # extra shapes for the ragged edges and the other head dims: a q tile
    # past sq, keys past sk, sq < sk, no segment ids
    for b, h, sq, sk, d, causal in ((2, 3, 77, 77, 64, True),
                                    (1, 2, 40, 130, 128, True),
                                    (2, 2, 100, 100, 32, False)):
        q, k, v = rand(b, h, sq, d), rand(b, h, sk, d), rand(b, h, sk, d)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
        bf16_err(out, ref, 4e-3, f"flash b{b} h{h} sq{sq} sk{sk} d{d}")
        check((lse - ref_lse).abs().max().item() <= 1e-3, "flash lse")

    b, h, s, d, live = 1, 16, 512, 64, 300
    q, k, v = rand(b, h, s, d), rand(b, h, s, d), rand(b, h, s, d)
    sid = torch.where(torch.arange(s, device="cuda") < live, 0, -1)
    sid = sid.to(torch.int32)[None].contiguous()
    scale = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, sid, None, True, scale)
    ref, ref_lse = fa.flash_attention_reference(
        q, k, v, causal=True, segment_ids_q=sid, scale=scale)
    torch.cuda.synchronize()
    err = bf16_err(out, ref, 4e-3, "flash")
    lse_err = (lse - ref_lse).abs().max().item()
    # lse is fp32 in both: only the summation order and __expf differ
    check(lse_err <= 1e-3, f"flash lse max err {lse_err} > 1e-3")
    check(out[:, :, live:].abs().max().item() == 0.0,
          "flash: padded rows are not exactly zero")
    ms = timer(lambda: fa.flash_attention_fwd(q, k, v, sid, None, True,
                                              scale))
    plain_ms = timer(lambda: fa.flash_attention_reference(
        q, k, v, causal=True, segment_ids_q=sid, scale=scale))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale))
    pairs = s * (s + 1) // 2                     # causal (q, k) pairs
    flops = 4.0 * b * h * d * pairs
    nbytes = 4 * b * h * s * d * 2 + b * h * s * 4 + b * s * 4
    t_bound, by = bound(flops, nbytes)
    return dict(name="flash_fwd", route="cuda",
                source="apex_tpu_torch/csrc/flash_fwd.cu",
                replaces="apex_tpu/ops/flash_attention.py:251",
                shape=f"b{b} h{h} s{s} d{d} bf16 causal, segment ids -1 "
                      f"from {live}",
                max_abs_err=err, tolerance="2 bf16 ulp + 4e-3",
                lse_max_abs_err=lse_err,
                ms=ms, plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                library_ms=lib_ms,
                library="F.scaled_dot_product_attention(is_causal=True), "
                        "no segment ids")


def _paged_inputs(torch, gen, b, kv, g, d, page, m, num_pages, seq_lens):
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
        bt[i, :need] = pages[used:used + need]
        used += need
    bt = torch.from_numpy(bt).cuda()
    sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, sl


def check_paged(torch, timer):
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(3)
    # GQA group 3, a dead slot, a partial page
    q, kp, vp, bt, sl = _paged_inputs(torch, gen, 3, 2, 3, 64, 16, 4, 9,
                                      [13, 0, 64])
    out = fa.paged_decode_attention(q, kp, vp, bt, sl)
    ref = fa.paged_attention_reference(q, kp, vp, bt, sl)
    bf16_err(out, ref, 1e-3, "paged GQA group 3")
    check(out[1].abs().max().item() == 0.0, "paged: dead slot not zero")

    b, kv, g, d, page, m, num_pages = 8, 16, 1, 64, 128, 8, 72
    seq_lens = [0, 1, 127, 128, 129, 300, 640, 1024]
    q, kp, vp, bt, sl = _paged_inputs(torch, gen, b, kv, g, d, page, m,
                                      num_pages, seq_lens)
    out = fa.paged_decode_attention(q, kp, vp, bt, sl)
    ref = fa.paged_attention_reference(q, kp, vp, bt, sl)
    torch.cuda.synchronize()
    # p and the accumulators stay fp32 in both: only the output rounding
    err = bf16_err(out, ref, 1e-3, "paged")
    check(out[0].abs().max().item() == 0.0, "paged: inactive slot not zero")
    ms = timer(lambda: fa.paged_decode_attention(q, kp, vp, bt, sl))
    plain_ms = timer(lambda: fa.paged_attention_reference(q, kp, vp, bt, sl))
    live = sum(seq_lens)
    flops = 4.0 * kv * g * d * live
    nbytes = (2 * kv * d * 2 * live + 2 * b * kv * g * d * 2
              + b * m * 4 + b * 4)
    t_bound, by = bound(flops, nbytes)
    return dict(name="paged_decode", route="cuda",
                source="apex_tpu_torch/csrc/paged_decode.cu",
                replaces="apex_tpu/ops/flash_attention.py:986",
                shape=f"b{b} kv{kv} g{g} d{d} page{page} m{m} "
                      f"seq_lens {seq_lens}",
                max_abs_err=err, tolerance="2 bf16 ulp + 1e-3", ms=ms,
                plain_ms=plain_ms,
                bound_ms=t_bound, bound_by=by, library_ms=None)


def check_layer_norm(torch, timer):
    import torch.nn.functional as F
    from apex_tpu_torch.ops import layer_norm as ln
    gen = torch.Generator(device="cuda").manual_seed(4)
    h = 1024
    w = 1 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    bb = 0.1 * torch.randn(h, generator=gen, device="cuda")
    shapes = []
    for n in (8, 512):
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
        nbytes = 2 * n * h * 2 + 2 * h * 4
        t_bound, by = bound(10.0 * n * h, nbytes)
        shapes.append(dict(n=n, h=h, max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                           library_ms=lib_ms))
    main = shapes[-1]                      # the prefill shape, n = 512
    return dict(name="layer_norm_fwd", route="triton",
                source="apex_tpu_torch/ops/layer_norm.py",
                replaces="apex_tpu/ops/layer_norm.py:131",
                shape=f"n512 h{h} bf16 in/out, fp32 params",
                max_abs_err=max(s["max_abs_err"] for s in shapes),
                tolerance="one bf16 ulp", ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"],
                library="F.layer_norm with bf16 weight/bias",
                by_shape=shapes)


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

N_REQUESTS, N_NEW = 16, 64


def gpt_config():
    import torch
    from apex_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(vocab_size=32768, max_seq_len=1024, hidden_size=1024,
                     num_layers=12, num_heads=16, dtype=torch.bfloat16)


def make_engine(cfg, params):
    from apex_tpu_torch.serve import ServeEngine
    return ServeEngine(cfg, params, num_pages=72, page_size=128,
                       max_seq_len=1024, max_prompt_len=512, max_batch=8,
                       record_logits=True)


def counters():
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import layer_norm as ln
    return {"flash_fwd": fa.flash_attention,
            "paged_decode": fa.paged_decode_attention,
            "layer_norm_fwd": ln.fused_layer_norm_affine}


def run_main_path(torch, cfg, params):
    # warm-up: cuBLAS handles and Triton's first compile stay out of the
    # timed run (a separate engine, so its steps are not counted)
    warm = make_engine(cfg, params)
    warm.add_request(list(range(1, 65)), 2)
    warm.run()
    del warm
    torch.cuda.synchronize()

    eng = make_engine(cfg, params)
    rng = np.random.RandomState(0)
    lens = rng.randint(64, 513, size=N_REQUESTS)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]
    ids = [eng.add_request(p, N_NEW) for p in prompts]
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}

    check(all(len(out[i]) == N_NEW for i in ids),
          "a request did not return 64 tokens")
    check(eng.sched.allocator.free_pages == eng.ccfg.num_pages - 1,
          "pages were not all returned")
    check(eng.slots == [None] * eng.max_batch, "a slot leaked")
    check(sum(eng.seqs[i].n_preemptions for i in ids) == 0,
          "a preemption happened: the launch counts below assume none")
    n_prefill = len(eng.prefill_times)
    n_decode = len(eng.decode_step_times)
    check(n_prefill == N_REQUESTS, f"{n_prefill} prefills")
    expect = {"flash_fwd": 12 * n_prefill, "paged_decode": 12 * n_decode,
              "layer_norm_fwd": 25 * (n_prefill + n_decode)}
    for k in expect:
        check(launches[k] == expect[k],
              f"{k}: {launches[k]} launches, expected {expect[k]}")
        check(launches[k] > 0, f"{k} never launched on the main path")

    full = [t for t, n in zip(eng.decode_step_times, eng.decode_step_sizes)
            if n == eng.max_batch]
    dec_tokens = sum(eng.decode_step_sizes)
    stats = dict(
        requests=N_REQUESTS, new_tokens=N_NEW, wall_s=wall,
        tokens_per_s=eng.tokens_generated / wall,
        prefill_ms_by_len=sorted((n, 1e3 * t) for n, t in eng.prefill_times),
        decode_steps=n_decode,
        decode_step_ms_batch8_median=1e3 * float(np.median(full)),
        decode_step_ms_batch8_p90=1e3 * float(np.percentile(full, 90)),
        decode_steps_batch8=len(full),
        decode_tokens_per_s=dec_tokens / sum(eng.decode_step_times),
        launches=launches)
    return eng, ids, stats


def teacher_forced(torch, cfg, params, eng, ids):
    """The plain no-cache forward over prompt + generated tokens against the
    engine's recorded logits, every generated position of two requests."""
    from apex_tpu_torch.serve.model import full_forward_logits
    worst, worst_gap, n_pos, n_flip = 0.0, 0.0, 0, 0
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
                n_pos += 1
                a, b = int(got.argmax()), int(ref[r].argmax())
                if a != b:
                    n_flip += 1
                    worst_gap = max(worst_gap, float(ref[r][b] - ref[r][a]))
    return dict(positions=n_pos, max_abs_diff=worst, argmax_flips=n_flip,
                worst_flip_gap=worst_gap)


# max |logit| diff, bf16 engine vs the plain forward: ~6 bf16 ulps at the
# largest logits (|logit| < 4, ulp 2^-6); an argmax flip is allowed only
# where the plain logits of the two tokens are within 2 * TF_TOL
TF_TOL = 0.1
TF_TIE = 2 * TF_TOL


def trace(torch, cfg, params):
    """torch.profiler over 4 steady decode steps at batch 8 and over one
    prefill: device time by kernel and the device-busy share of the wall
    time (``None`` when the profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch.serve import model as model_mod
    eng = make_engine(cfg, params)
    rng = np.random.RandomState(1)
    for _ in range(eng.max_batch):
        eng.add_request(rng.randint(0, cfg.vocab_size, size=256).tolist(), 16)
    eng.step()                          # 8 prefills + the first decode
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=512)).cuda()
    # pages of its own for the extra prefill (400 live tokens)
    bt = torch.tensor(eng.sched.allocator.alloc(4), dtype=torch.int32,
                      device="cuda")

    def prefill():
        with torch.no_grad():
            model_mod.prefill_forward(cfg, eng.ccfg, params, eng.state, bt,
                                      400, ids)

    result = {}
    for name, fn, reps in (("decode_step_b8", eng.step, 4),
                           ("prefill_512", prefill, 2)):
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
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        result[name] = dict(
            wall_ms_per_call=wall_us / reps / 1e3,
            device_ms_per_call=dev_us / reps / 1e3,
            device_busy_share=(dev_us / wall_us) if dev_us else None,
            kernel_launches_per_call=sum(e.count for e in kern) / reps,
            top_device_ms_per_call=[
                (e.key[:60], e.self_device_time_total / reps / 1e3)
                for e in top])
    return result


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
    _build.build_all(["flash_fwd", "paged_decode"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name in ("flash_fwd", "paged_decode"):
        text = _build.library_path(name).with_suffix(".log").read_text()
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    timer = Timer(torch)
    kernels = [check_flash(torch, timer), check_paged(torch, timer),
               check_layer_norm(torch, timer)]
    for kr in kernels:
        log(f"kernel {kr['name']}: err {kr['max_abs_err']:.3g} "
            f"ms {kr['ms']:.4f} plain {kr['plain_ms']:.4f} "
            f"bound {kr['bound_ms']:.4f} ({kr['bound_by']}) "
            f"library {kr['library_ms']}")
    del timer

    cfg = gpt_config()
    t0 = time.perf_counter()
    params = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    log(f"params: {time.perf_counter() - t0:.1f} s")
    eng, ids, stats = run_main_path(torch, cfg, params)
    log(f"main path ({card}): " + json.dumps(stats))
    for kr in kernels:
        kr["launches"] = stats["launches"][kr["name"]]

    tf = teacher_forced(torch, cfg, params, eng, ids)
    log("teacher-forced: " + json.dumps(tf) + f" (tolerance {TF_TOL}, "
        f"near-tie margin {TF_TIE})")
    check(tf["max_abs_diff"] <= TF_TOL,
          f"teacher-forced logits differ by {tf['max_abs_diff']}")
    check(tf["worst_flip_gap"] <= TF_TIE,
          f"argmax flip with plain gap {tf['worst_flip_gap']}")

    log("trace: " + json.dumps(trace(torch, cfg, params)))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
