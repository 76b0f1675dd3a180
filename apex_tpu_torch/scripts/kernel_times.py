"""Times the port's kernels at their main paths' shapes, for one checkout.

bf16 kernels (and the LM-head CE's fp16 ones too) and the fp32 (O0)
ones, so that two versions of the repository can be compared on one card
in one run.

Run on a machine with a CUDA card, as a file (not with ``-m``), so that
``--root`` decides which checkout's ``apex_tpu_torch`` is imported::

    python3 apex_tpu_torch/scripts/kernel_times.py [--root DIR] [--out F]

Each kernel is called through its public wrapper (the same calls in every
version since the wrappers' first slice): flash forward at the serve
prefill's b1 h16 s512 (causal, segment ids -1 from 300), at b8 h16 s1024
d64 causal (the GPT train step) and b2 h16 s4096 (the long-sequence
step), the first three also at both block heights of the wgmma forward
where the checkout has it (``block_rows`` 64 and 128), and at b2 h8
s1024 d256 (the largest head dim every version runs); the single-pass backward at b8 h16 s1024 and b2 h8 s1024 d256 as
called (delta pass, dq accumulator and cast included) and alone at b8
h16 s1024 on a given delta and zeroed fp32 dq accumulator (the C entry
of whichever kernel the checkout routes bf16 d64 to); the split backward
at b2 h16 s4096 as called (delta included) and its two kernels apart
(``_flash_dkdv_cuda`` and ``_flash_dq_cuda`` on a given delta, the calls
every version since the split's first slice takes), paged decode over
the serve path's mixed batch and the speculative engine's draft and verify
calls (bf16 and e4m3 pools), the LM-head CE forward and backward at n8192
V32768 h1024 in bf16 and fp16, the fp8 matmul at the decode batch (m8)
and at one padded prompt (m512, its prefill regime) at the GPT's four
block linears (K1024 N3072, K1024 N1024, K1024 N4096, K4096 N1024), the
prompt's beside bf16 ``torch.matmul`` on the unquantized weight, the
LayerNorm backward at the train step's n8192 h1024 (bf16 x and dy; bf16
and fp32 parameters) beside ``F.layer_norm``'s autograd backward, the
fused bottleneck (B15, ``scripts/bottleneck_proto.py``'s ``fused_block``)
at N 32 beside its cuDNN composition, and the timer's own floor (a
one-element add).

µs-scale kernels read near the event pair's floor, so the Triton kernels
B6 (LayerNorm forward at m 8, 512 and 8192, h 1024, bf16 x; and m 8192 in
fp32, the O0 step's), B10 and B11 (softmax cross entropy forward and
backward at ResNet-50's [256, 1000] fp32 logits) are also timed by
``torch.profiler``'s CUPTI kernel durations (the L2 flushed before each
call, as for the event pairs), beside their event times and their bounds
(bytes at 3.35 TB/s against fp32 operations at 67 TFLOP/s), and so is the
one-element add, the profiler's own floor: the ``profiled`` object of the
result.

The fp32 (O0) rows, each beside the PyTorch call or composition that
computes the same function in exact fp32 (TF32 off, float32 matmul
precision "highest", both recorded): the LM-head CE forward and backward
at n8192 V32768 h1024 (``F.cross_entropy(F.linear(x, e), t)`` and its
autograd backward), the flash forward at b8 h16 s1024 d64 and d128 and
b2 h16 s4096 d64 causal, the single pass at b8 h16 s1024 d64 and d128,
the split's two kernels at b2 h16 s4096 (the dq kernel also as the split
calls it, on the scratch its dk/dv call transposed q and dO into, where
the checkout has one) and the split as called (SDPA forward and
backward); the forward, the single pass and the split's dk/dv and dq of
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (the shuffle-product
kernels) through their C entries at the same shapes, whichever kernel
the checkout routes fp32 to, so that a checkout's route is timed beside
the kernels every version has; and one O0 step of the 2-layer GPT
(h1024, V32768, FusedAdam) at b8 s1024 and at b2 s4096 under
``torch.profiler``, its device time by kernel class and its host-clock
time. Times are medians of CUDA-event pairs around single launches, the L2 flushed before
each. They are device times: a ``torch.cuda._sleep`` queued between the
flush and the start event keeps the card busy while the host records the
start event and runs the wrapper, so the pair holds no host time. The
result is one JSON object (also written to ``--out``) with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time


def _args():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose apex_tpu_torch is timed "
                         "(default: the one holding this file)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    return ap.parse_args()


def _grad_closure(torch, fn, inputs, dout):
    """A closure running the autograd backward of ``fn(*inputs)`` (the
    forward runs once, outside the timed call)."""
    ins = [t.detach().requires_grad_() for t in inputs]
    out = fn(*ins)
    return lambda: torch.autograd.grad(out, ins, dout, retain_graph=True)


def _fp32_rows(torch, F, fa, ce, timed, x, e, tgt, dl):
    """The fp32 kernels of the O0 paths beside their library calls."""
    res = {}
    n = x.shape[0]
    m, l, _, _ = ce.lm_head_ce_fwd_reference(x, e, tgt)
    res["lm_head_ce_fwd fp32 n8192 h1024"] = timed(
        lambda: ce.lm_head_ce_fwd(x, e, tgt), iters=5)
    res["lm_head_ce_bwd fp32 n8192 h1024"] = timed(
        lambda: ce.lm_head_ce_bwd(x, e, tgt, m, l, dl), iters=5)
    res["library fp32 CE fwd: F.cross_entropy(F.linear)"] = timed(
        lambda: F.cross_entropy(F.linear(x, e), tgt.long()), iters=5)
    res["library fp32 CE bwd: autograd of the same"] = timed(
        _grad_closure(torch, lambda a, w: F.cross_entropy(
            F.linear(a, w), tgt.long()), (x, e),
            torch.ones((), device="cuda")), iters=5)
    del m, l
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                              scale=0.125)

    q, k, v, do = (rnd(8, 16, 1024, 64) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    res["flash_fwd fp32 b8 s1024"] = timed(
        lambda: fa.flash_attention_fwd(q, k, v, causal=True), iters=5)
    res["library fp32 SDPA fwd b8 s1024"] = timed(lambda: sdpa(q, k, v),
                                                  iters=5)
    res["flash_fwd.cu fp32 b8 s1024 (C entry)"] = timed(
        _shuffle_fwd(torch, fa, q, k, v), iters=3)
    res["flash_bwd single fp32 b8 s1024"] = timed(
        lambda: fa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, True,
                                   0.125, split=False), iters=5)
    res["library fp32 SDPA bwd b8 s1024"] = timed(
        _grad_closure(torch, sdpa, (q, k, v), do), iters=5)
    res["flash_bwd.cu single fp32 b8 s1024 (C entry)"] = timed(
        _shuffle_single(torch, fa, q, k, v, out, lse, do), iters=3)
    del q, k, v, do, out, lse
    q, k, v, do = (rnd(8, 16, 1024, 128) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    res["flash_fwd fp32 b8 s1024 d128"] = timed(
        lambda: fa.flash_attention_fwd(q, k, v, causal=True), iters=5)
    res["library fp32 SDPA fwd b8 s1024 d128"] = timed(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               scale=128 ** -0.5), iters=5)
    res["flash_fwd.cu fp32 b8 s1024 d128 (C entry)"] = timed(
        _shuffle_fwd(torch, fa, q, k, v), iters=3)
    res["flash_bwd single fp32 b8 s1024 d128"] = timed(
        lambda: fa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, True,
                                   128 ** -0.5, split=False), iters=5)
    res["library fp32 SDPA bwd b8 s1024 d128"] = timed(
        _grad_closure(torch, lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=True, scale=128 ** -0.5), (q, k, v), do),
        iters=5)
    del q, k, v, do, out, lse
    q, k, v, do = (rnd(2, 16, 4096, 64) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    res["flash_fwd fp32 b2 s4096"] = timed(
        lambda: fa.flash_attention_fwd(q, k, v, causal=True), iters=3)
    res["library fp32 SDPA fwd b2 s4096"] = timed(lambda: sdpa(q, k, v),
                                                  iters=3)
    res["flash_fwd.cu fp32 b2 s4096 (C entry)"] = timed(
        _shuffle_fwd(torch, fa, q, k, v), iters=3)
    delta = (do * out).sum(dim=-1)
    args = (q, k, v, do, lse, delta, None, None, True, 0.125,
            fa._mixed_rounds(q, k, do))
    res["flash_bwd dkdv fp32 b2 s4096"] = timed(
        lambda: fa._flash_dkdv_cuda(*args), iters=3)
    dkdv = fa._build.function("flash_bwd@f32", "apex_flash_bwd_dkdv",
                              fa._FLASH_DKDV_ARGS)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    res["flash_bwd.cu dkdv fp32 b2 s4096 (C entry)"] = timed(
        lambda: dkdv(fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(do),
                     fa._ptr(lse), fa._ptr(delta), None, None, fa._ptr(dk),
                     fa._ptr(dv), 2, 16, 4096, 4096, 64, 1, 0.125, 2,
                     args[-1], fa._stream(q)), iters=3)
    res["flash_bwd dq fp32 b2 s4096"] = timed(
        lambda: fa._flash_dq_cuda(*args), iters=3)
    # the dq kernel as the split calls it: on the scratch its dk/dv call
    # filled with q and do transposed, where the checkout has one
    if "ws" in inspect.signature(fa._flash_dq_cuda).parameters:
        ws = fa._f32_transposes(q)
        fa._flash_dkdv_cuda(*args, ws=ws)
        res["flash_bwd dq fp32 b2 s4096 in the split"] = timed(
            lambda: fa._flash_dq_cuda(*args, ws=ws), iters=3)
    else:
        res["flash_bwd dq fp32 b2 s4096 in the split"] = res[
            "flash_bwd dq fp32 b2 s4096"]
    dq_old = fa._build.function("flash_bwd@f32", "apex_flash_bwd_dq",
                                fa._FLASH_DQ_ARGS)
    dq = torch.empty_like(q)
    res["flash_bwd.cu dq fp32 b2 s4096 (C entry)"] = timed(
        lambda: dq_old(fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(do),
                       fa._ptr(lse), fa._ptr(delta), None, None, fa._ptr(dq),
                       2, 16, 4096, 4096, 64, 1, 0.125, 2, args[-1],
                       fa._stream(q)), iters=3)
    res["flash_bwd split fp32 b2 s4096"] = timed(
        lambda: fa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, True,
                                   0.125, split=True), iters=3)
    res["library fp32 SDPA bwd b2 s4096"] = timed(
        _grad_closure(torch, sdpa, (q, k, v), do), iters=3)
    return res


def _shuffle_fwd(torch, fa, q, k, v):
    """A closure running ``csrc/flash_fwd.cu``'s fp32 forward (the
    shuffle-product kernel) through its C entry, causal, at q's head dim
    (64 or 128)."""
    b, h, s, d = q.shape
    fn = fa._build.function("flash_fwd@f32", "apex_flash_fwd",
                            fa._FLASH_ARGS)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    return lambda: fn(fa._ptr(q), fa._ptr(k), fa._ptr(v), None, None,
                      fa._ptr(out), fa._ptr(lse), b, h, s, s, d, 1,
                      d ** -0.5, 2, 2, fa._stream(q))


def _shuffle_single(torch, fa, q, k, v, out, lse, do):
    """A closure running ``csrc/flash_bwd.cu``'s fp32 single pass through
    its C entry at kernel head dim 64 (delta and a zeroed dq workspace
    made outside: the turn counters must start at zero on every call)."""
    b, h, s, d = q.shape
    fn = fa._build.function("flash_bwd@f32", "apex_flash_bwd",
                            fa._FLASH_BWD_ARGS)
    delta = (do * out).sum(dim=-1)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rounds = fa._mixed_rounds(q, k, do)
    ws = [fa._dq_workspace(q, d, False) for _ in range(8)]
    box = [0]

    def run():
        dq_acc, turns = ws[box[0] % len(ws)]
        box[0] += 1
        dq_acc.zero_()
        turns.zero_()
        fn(fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(do), fa._ptr(lse),
           fa._ptr(delta), None, None, fa._ptr(dq_acc), fa._ptr(turns),
           fa._ptr(dk), fa._ptr(dv), b, h, s, s, d, 1, d ** -0.5, 2, rounds,
           fa._stream(q))

    return run


# kernel classes of the O0 step's trace, by a part of the kernel's name
_O0_CLASSES = (
    ("LM-head CE (B8, B9)", ("ce_fwd_kernel", "ce_bwd_de_kernel",
                             "ce_bwd_dx_kernel", "ce32_")),
    ("flash forward (B1)", ("flash_fwd",)),
    ("flash backward (B2, B3, B4)", ("flash_bwd", "flash_dkdv", "flash_dq",
                                     "flash_f32_prologue")),
    ("LayerNorm (B6, B7)", ("_ln_fwd", "_ln_bwd", "ln_bwd_")),
    ("library GEMM", ("gemm", "nvjet", "xmma", "cutlass")),
    ("memcpy/memset", ("Memcpy", "Memset", "memcpy", "memset")),
)


def _o0_step(torch, b=8, s=1024):
    """One O0 step (2-layer fp32 GPT at h1024 V32768, b8 s1024 or b2 s4096,
    ``FusedAdam`` through ``amp.make_train_step``) after a warm-up:
    the host-clock median of 3 steps, then one step under
    ``torch.profiler``, device ms and launches by kernel class."""
    import dataclasses
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import GPT, GPTConfig
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = dataclasses.replace(
        GPTConfig(vocab_size=32768, max_seq_len=s, hidden_size=1024,
                  num_layers=12, num_heads=16, dtype=torch.bfloat16),
        num_layers=2, dtype=torch.float32)
    model = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int64)).cuda()
    labels = torch.roll(ids, -1, dims=1)
    amp_model, opt = amp.initialize(model, FusedAdam(lr=3e-4),
                                    opt_level="O0", verbosity=0)
    amp_model.cast_params()
    box = [opt.init(model.parameters()), opt._scaler.state]
    step = amp.make_train_step(lambda m, i, l: m.loss(i, l), opt)

    def one():
        _, box[0], box[1], _ = step(model, box[0], box[1], ids, labels)
        torch.cuda.synchronize()

    one()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        one()
        times.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one()
    by_class = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        cls = next((c for c, keys in _O0_CLASSES
                    if any(k in ev.key for k in keys)),
                   "other PyTorch kernels")
        ms, count = by_class.get(cls, (0.0, 0))
        by_class[cls] = (ms + ev.self_device_time_total / 1e3,
                         count + ev.count)
    return dict(step_ms_median=float(np.median(times)), step_ms_all=times,
                device_ms=sum(ms for ms, _ in by_class.values()),
                device_ms_and_launches_by_class=dict(sorted(
                    by_class.items(), key=lambda kv: -kv[1][0])))


HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12        # fp32 outside the tensor cores


def _profiled_ms(torch, fn, key, flush, calls=20):
    """Mean CUPTI duration (ms) of the device kernels whose name holds
    ``key``, over ``calls`` calls of ``fn`` under ``torch.profiler``, the
    L2 flushed before each; and the launches seen (``calls`` expected)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and key in ev.key:
            us += ev.self_device_time_total
            count += ev.count
    return (us / 1e3 / count if count else None), count


def _triton_rows(torch, timed, flush):
    """B6, B10 and B11 by event pair and by the profiler, with bounds."""
    from apex_tpu_torch.ops import fused_ce as xe
    from apex_tpu_torch.ops import layer_norm as ln
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}

    def row(name, fn, key, nbytes, flops):
        prof_ms, seen = _profiled_ms(torch, fn, key, flush)
        out[name] = dict(event_ms=timed(fn), profiler_ms=prof_ms,
                         profiler_launches=seen,
                         bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                      flops / FP32_FLOPS_PER_S) * 1e3,
                         bound_by="bytes" if nbytes / HBM_BYTES_PER_S >=
                         flops / FP32_FLOPS_PER_S else "operations")

    # the floor: a one-element add (its kernel's name holds "_add")
    tiny = torch.zeros(1, device="cuda")
    row("timer floor: one-element add", lambda: tiny.add_(1.0),
        "_add", 8, 1.0)
    h = 1024
    for m, x_dt, p_dt in ((8, torch.bfloat16, torch.float32),
                          (512, torch.bfloat16, torch.float32),
                          (8192, torch.bfloat16, torch.bfloat16),
                          (8192, torch.float32, torch.float32)):
        x = torch.randn(m, h, generator=gen, device="cuda").to(x_dt)
        w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(p_dt)
        b = (0.1 * torch.randn(h, generator=gen, device="cuda")).to(p_dt)
        row(f"B6 LN fwd m{m} h{h} {str(x_dt)[6:]} x, {str(p_dt)[6:]} params",
            lambda: ln.fused_layer_norm_affine(x, w, b, (h,), 1e-5, x_dt),
            "_ln_fwd", 2 * m * h * x.element_size() + 2 * h * w.element_size(),
            10.0 * m * h)
    n, V, ls = 256, 1000, 0.1
    x = 3 * torch.randn(n, V, generator=gen, device="cuda")
    tgt = torch.randint(0, V, (n,), generator=gen, device="cuda").to(
        torch.int32)
    dl = torch.full((n,), 1.0 / n, device="cuda")
    _, m_, l_ = xe._xent_fwd_cuda(x, tgt, ls)
    row("B10 softmax CE fwd [256, 1000] fp32",
        lambda: xe._xent_fwd_cuda(x, tgt, ls), "_ce_fwd",
        n * V * 4 + n * 4 + 3 * n * 4, 12.0 * n * V)
    row("B11 softmax CE bwd [256, 1000] fp32",
        lambda: xe._xent_bwd_cuda(x, tgt, m_, l_, dl, ls), "_ce_bwd",
        2 * n * V * 4 + 4 * n * 4, 7.0 * n * V)
    return out


def main() -> int:
    args = _args()
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(args.root or os.path.join(here, "..", ".."))
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from apex_tpu_torch.amp import fp8
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fp8_matmul as mm
    from apex_tpu_torch.ops import lm_head_ce as ce
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    # ~150 us at the H100's 1.98 GHz: more than a wrapper's host time
    sleep_cycles = 300_000

    def timed(fn, iters=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ev = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(sleep_cycles)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            ev.append((a, b))
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(b) for a, b in ev]))

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen,
                                    device="cuda")).to(torch.bfloat16)

    res = {}
    # the timer's own floor: a one-element add
    tiny = torch.zeros(1, device="cuda")
    res["timer floor: one-element add"] = timed(lambda: tiny.add_(1.0))
    q, k, v = (rnd(1, 16, 512, 64) for _ in range(3))
    sid = torch.where(torch.arange(512, device="cuda") < 300, 0, -1).to(
        torch.int32)[None].contiguous()
    res["flash_fwd serve b1 s512 seg"] = timed(
        lambda: fa.flash_attention_fwd(q, k, v, sid, None, True))
    # the wgmma forward at both block heights, where the checkout has it
    rows = ((64, 128) if "block_rows" in inspect.signature(
        fa._flash_fwd_cuda).parameters else ())

    def fwd_rows(name, q, k, v, sid, iters=30):
        for r in rows:
            res[f"{name} rows{r}"] = timed(lambda: fa._flash_fwd_cuda(
                q, k, v, sid, None, True, 0.125, block_rows=r), iters)

    fwd_rows("flash_fwd serve b1 s512 seg", q, k, v, sid)
    q, k, v = (rnd(2, 16, 4096, 64) for _ in range(3))
    res["flash_fwd b2 s4096"] = timed(
        lambda: fa.flash_attention_fwd(q, k, v, causal=True), iters=10)
    fwd_rows("flash_fwd b2 s4096", q, k, v, None, iters=10)
    q, k, v, do = (rnd(8, 16, 1024, 64) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    res["flash_fwd b8 s1024"] = timed(
        lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    fwd_rows("flash_fwd b8 s1024", q, k, v, None)
    res["flash_bwd single b8 s1024"] = timed(
        lambda: fa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, True,
                                   0.125, split=False))
    delta = (do.float() * out.float()).sum(dim=-1)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    if hasattr(fa, "_flash_bwd_fused_cuda"):        # the wgmma route
        def single_alone():
            fa._flash_bwd_fused_cuda(q, k, v, do, lse, delta, None, None,
                                     True, 0.125, dq_acc)
    else:                                           # flash_bwd.cu
        fn = fa._build.function("flash_bwd@bf16", "apex_flash_bwd",
                                fa._FLASH_BWD_ARGS)
        dk, dv = torch.empty_like(k), torch.empty_like(v)

        def single_alone():
            fn(fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(do), fa._ptr(lse),
               fa._ptr(delta), None, None, fa._ptr(dq_acc), fa._ptr(dk),
               fa._ptr(dv), 8, 16, 1024, 1024, 64, 1, 0.125, 0,
               fa._mixed_rounds(q, k, do), fa._stream(q))
    res["flash_bwd single alone b8 s1024"] = timed(single_alone)
    del delta, dq_acc
    q, k, v, do = (rnd(2, 8, 1024, 256) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    res["flash_fwd b2 s1024 d256"] = timed(
        lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    res["flash_bwd single b2 s1024 d256"] = timed(
        lambda: fa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, True,
                                   0.0625, split=False))
    q, k, v, do = (rnd(2, 16, 4096, 64) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    res["flash_bwd split b2 s4096"] = timed(
        lambda: fa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, True,
                                   0.125, split=True), iters=10)
    delta = (do.float() * out.float()).sum(dim=-1)
    split_args = (q, k, v, do, lse, delta, None, None, True, 0.125,
                  fa._mixed_rounds(q, k, do))
    res["flash_bwd dkdv b2 s4096"] = timed(
        lambda: fa._flash_dkdv_cuda(*split_args), iters=10)
    res["flash_bwd dq b2 s4096"] = timed(
        lambda: fa._flash_dq_cuda(*split_args), iters=10)
    res["flash_bwd delta pass b2 s4096"] = timed(
        lambda: (do.float() * out.float()).sum(dim=-1), iters=10)
    del delta, split_args
    del q, k, v, do, out, lse

    kv, page, d, num_pages, m = 16, 128, 64, 72, 8
    # the serve engines' decode calls: the mixed batch, the speculative
    # engine's draft call (one active row) and verify call (five rows of
    # one sequence over one block table)
    for name, seq_lens, one_table in (
            ("", [0, 1, 127, 128, 129, 300, 640, 1024], False),
            (" spec draft", [300, 0, 0, 0, 0, 0, 0, 0], False),
            (" spec verify", [300, 301, 302, 303, 304, 0, 0, 0], True)):
        qd = rnd(8, kv, 1, d)
        kp, vp = rnd(kv, num_pages, page, d), rnd(kv, num_pages, page, d)
        rng = np.random.RandomState(2)
        pages = rng.permutation(np.arange(1, num_pages))
        bt = np.zeros((8, m), np.int32)
        used = 0
        for i, n in enumerate(seq_lens):
            need = -(-n // page)
            bt[i, :need] = pages[:need] if one_table else \
                pages[used:used + need]
            used += 0 if one_table else need
        bt = torch.from_numpy(bt).cuda()
        sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
        res[f"paged_decode bf16{name}"] = timed(
            lambda: fa.paged_decode_attention(qd, kp, vp, bt, sl))
        ks = fp8.compute_scale(kp.float().abs().amax(dim=(2, 3)),
                               fp8.E4M3_MAX, 2.0)
        k8 = fp8.quantize(kp.float(), ks[..., None, None], fp8.E4M3)
        v8 = fp8.quantize(vp.float(), ks[..., None, None], fp8.E4M3)
        res[f"paged_decode e4m3{name}"] = timed(
            lambda: fa.paged_decode_attention(qd, k8, v8, bt, sl,
                                              k_scales=ks, v_scales=ks))

    n, V, h = 8192, 32768, 1024
    x, e = rnd(n, h), rnd(V, h, scale=0.02)
    tgt = torch.randint(0, V, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    mm_, ll, _, _ = ce.lm_head_ce_fwd_reference(x, e, tgt)
    dl = torch.full((n,), 1.0 / n, device="cuda")
    res["lm_head_ce_fwd n8192 h1024"] = timed(
        lambda: ce.lm_head_ce_fwd(x, e, tgt), iters=10)
    res["lm_head_ce_bwd n8192 h1024"] = timed(
        lambda: ce.lm_head_ce_bwd(x, e, tgt, mm_, ll, dl), iters=10)
    x32, e32 = x.float(), e.float()
    x, e = x.half(), e.half()
    res["lm_head_ce_fwd fp16 n8192 h1024"] = timed(
        lambda: ce.lm_head_ce_fwd(x, e, tgt), iters=10)
    res["lm_head_ce_bwd fp16 n8192 h1024"] = timed(
        lambda: ce.lm_head_ce_bwd(x, e, tgt, mm_, ll, dl), iters=10)
    del x, e
    res.update(_fp32_rows(torch, F, fa, ce, timed, x32, e32, tgt, dl))
    del x32, e32

    # the four block linears of the GPT at the decode batch and at one
    # padded prompt (the prefill regime), the prompt's beside bf16 matmul
    for K, N in ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)):
        wf = torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5
        wq, sc = mm.quantize_weight(wf)
        for m in (8, 512):
            xq = rnd(m, K)
            res[f"fp8_matmul m{m} K{K} N{N}"] = timed(
                lambda: mm.fp8_dequant_matmul(xq, wq, sc))
        wb = wf.to(torch.bfloat16)
        res[f"library bf16 matmul m512 K{K} N{N}"] = timed(
            lambda: torch.matmul(xq, wb))
    del xq, wq, wb, wf

    # the LayerNorm backward at the train step's shape
    from apex_tpu_torch.ops import layer_norm as ln
    xl, dyl = rnd(8192, 1024), rnd(8192, 1024)
    for p_dtype in (torch.bfloat16, torch.float32):
        wl = (1 + 0.1 * torch.randn(1024, generator=gen, device="cuda")).to(
            p_dtype)
        res[f"layer_norm_bwd n8192 h1024 {str(p_dtype)[6:]} params"] = timed(
            lambda: ln.layer_norm_bwd(xl, wl, dyl, (1024,), 1e-5))
    wl = wl.to(torch.bfloat16)
    res["library F.layer_norm bwd n8192 h1024"] = timed(_grad_closure(
        torch, lambda a, ww, bb: F.layer_norm(a, (1024,), ww, bb, 1e-5),
        (xl, wl, torch.zeros_like(wl)), dyl))
    del xl, dyl, wl

    # the fused bottleneck at the proto's N 32, beside the cuDNN composition
    from apex_tpu_torch.scripts import bottleneck_proto as bp
    torch.backends.cudnn.allow_tf32 = False
    pb = bp.make_params(device="cuda")
    xb = bp.make_input(bp.N, device="cuda")
    wts = bp.cudnn_weights(pb)
    res["bottleneck B15 n32"] = timed(lambda: bp.fused_block(xb, pb))
    res["library cuDNN composition n32"] = timed(
        lambda: bp.cudnn_block(xb, pb, wts))
    del xb, pb, wts
    profiled = _triton_rows(torch, timed, flush)

    o0 = _o0_step(torch)
    o0_long = _o0_step(torch, 2, 4096)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = dict(root=root, card=card, ms=res, profiled=profiled, o0_step=o0,
               o0_step_s4096=o0_long,
               fp32_matmul=dict(
                   allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                   precision=torch.get_float32_matmul_precision()),
               at=time.time())
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
