"""Times the port's kernels at their main paths' shapes, for one checkout.

bf16 kernels (and the LM-head CE's fp16 ones too), so that two versions
of the repository can be compared on one card in one run.

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
the serve path's batch (bf16 and e4m3 pools), the LM-head CE forward and
backward at n8192 V32768 h1024 in bf16 and fp16, the fp8 matmul at
decode qkv (m8 K1024 N3072). Times are medians of CUDA-event pairs
around single launches, the L2 flushed before each. They are device
times: a ``torch.cuda._sleep`` queued between the flush and the start
event keeps the card busy while the host records the start event and
runs the wrapper, so the pair holds no host time. The result is one
JSON object (also written to ``--out``) with the card's name and power
limit.
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


def main() -> int:
    args = _args()
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(args.root or os.path.join(here, "..", ".."))
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from apex_tpu_torch.amp import fp8
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fp8_matmul as mm
    from apex_tpu_torch.ops import lm_head_ce as ce
    torch.backends.cuda.matmul.allow_tf32 = False
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
    seq_lens = [0, 1, 127, 128, 129, 300, 640, 1024]
    qd = rnd(8, kv, 1, d)
    kp, vp = rnd(kv, num_pages, page, d), rnd(kv, num_pages, page, d)
    rng = np.random.RandomState(2)
    pages = rng.permutation(np.arange(1, num_pages))
    bt = np.zeros((8, m), np.int32)
    used = 0
    for i, n in enumerate(seq_lens):
        need = -(-n // page)
        bt[i, :need] = pages[used:used + need]
        used += need
    bt = torch.from_numpy(bt).cuda()
    sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    res["paged_decode bf16"] = timed(
        lambda: fa.paged_decode_attention(qd, kp, vp, bt, sl))
    ks = fp8.compute_scale(kp.float().abs().amax(dim=(2, 3)), fp8.E4M3_MAX,
                           2.0)
    k8 = fp8.quantize(kp.float(), ks[..., None, None], fp8.E4M3)
    v8 = fp8.quantize(vp.float(), ks[..., None, None], fp8.E4M3)
    res["paged_decode e4m3"] = timed(
        lambda: fa.paged_decode_attention(qd, k8, v8, bt, sl, k_scales=ks,
                                          v_scales=ks))

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
    x, e = x.half(), e.half()
    res["lm_head_ce_fwd fp16 n8192 h1024"] = timed(
        lambda: ce.lm_head_ce_fwd(x, e, tgt), iters=10)
    res["lm_head_ce_bwd fp16 n8192 h1024"] = timed(
        lambda: ce.lm_head_ce_bwd(x, e, tgt, mm_, ll, dl), iters=10)
    del x, e

    xq = rnd(8, 1024)
    wq, sc = mm.quantize_weight(torch.randn(1024, 3072, generator=gen,
                                            device="cuda") / 32)
    res["fp8_matmul m8 K1024 N3072"] = timed(
        lambda: mm.fp8_dequant_matmul(xq, wq, sc))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = dict(root=root, card=card, ms=res, at=time.time())
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
