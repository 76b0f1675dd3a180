"""Times the port's bf16 kernels at their main paths' shapes, for one
checkout of the repository, so that two versions can be compared on one
card in one run.

Run on a machine with a CUDA card, as a file (not with ``-m``), so that
``--root`` decides which checkout's ``apex_tpu_torch`` is imported::

    python3 apex_tpu_torch/scripts/kernel_times.py [--root DIR] [--out F]

Each kernel is called through its public wrapper (the same calls in every
version since the wrappers' first slice): flash forward and the
single-pass backward at b8 h16 s1024 d64 causal (the GPT train step),
the split backward at b2 h16 s4096, paged decode over the serve path's
batch (bf16 and e4m3 pools), the LM-head CE forward and backward at n8192
V32768 h1024, the fp8 matmul at decode qkv (m8 K1024 N3072). Times are
medians of CUDA-event pairs around single launches, the L2 flushed before
each; the result is one JSON object (also written to ``--out``) with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
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

    def timed(fn, iters=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ev = []
        for _ in range(iters):
            flush.zero_()
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
    q, k, v, do = (rnd(8, 16, 1024, 64) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    res["flash_fwd b8 s1024"] = timed(
        lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    res["flash_bwd single b8 s1024"] = timed(
        lambda: fa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, True,
                                   0.125, split=False))
    q, k, v, do = (rnd(2, 16, 4096, 64) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    res["flash_bwd split b2 s4096"] = timed(
        lambda: fa._flash_bwd_cuda(q, k, v, out, lse, do, None, None, True,
                                   0.125, split=True), iters=10)
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
