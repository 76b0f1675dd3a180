"""Times the port's serve engines end to end, for one checkout.

The engines of ``chip_smoke.py``'s serve paths (bf16; fp8 weights + fp8
KV; fp8 weights + ``spec_k=4``), at the same size: the 12-layer h1024 GPT
(V32768, bf16, random weights from seed 0), 72 pages of 128 tokens,
``max_batch`` 8, 16 requests of 64-512 prompt tokens (numpy seed 0), 64
new tokens each. Each engine is warmed once (a short request through its
own engine), then drained ``--reps`` times, each time a new engine; every
reading is kept. So that two versions of the repository can be compared
on one card in one run, call it once per checkout, alternating (parent,
change, change, parent).

Run on a machine with a CUDA card, as a file (not with ``-m``), so that
``--root`` decides which checkout's ``apex_tpu_torch`` is imported::

    python3 apex_tpu_torch/scripts/serve_times.py [--root DIR] [--out F]
        [--engines serve,serve-fp8,serve-spec-fp8w] [--reps N]
        [--build-only] [--wrappers]

The result is one JSON object (also written to ``--out``): per engine
and drain, tokens/s over the drain's wall time, the decode step's median
and p90 and the prefill median (the engine's own host-clock timings),
with the card's name and power limit. ``--wrappers`` adds the host time
of one call of each kernel wrapper the engines call per layer, at their
shapes (the median over 10 rounds of 200 calls issued back to back, the
card synchronized between rounds and not inside them): the engines are
host-bound, so this is the wrappers' share of a step.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ENGINES = {
    "serve": {},
    "serve-fp8": dict(fp8_weights=True, fp8_kv=True),
    "serve-spec-fp8w": dict(fp8_weights=True, spec_k=4),
}
N_REQUESTS, N_NEW = 16, 64


def _args():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose apex_tpu_torch is timed "
                         "(default: the one holding this file)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--engines", default=",".join(ENGINES),
                    help="comma-separated, of " + ", ".join(ENGINES))
    ap.add_argument("--reps", type=int, default=2,
                    help="drains per engine")
    ap.add_argument("--build-only", action="store_true",
                    help="only compile the kernels the engines launch")
    ap.add_argument("--wrappers", action="store_true",
                    help="also time the kernel wrappers' host work")
    return ap.parse_args()


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _engine(cfg, params, kw):
    from apex_tpu_torch.serve import ServeEngine
    return ServeEngine(cfg, params, num_pages=72, page_size=128,
                       max_seq_len=1024, max_prompt_len=512, max_batch=8,
                       record_logits=True, **kw)


def _drain(torch, np, cfg, params, kw):
    rng = np.random.RandomState(0)
    lens = rng.randint(64, 513, size=N_REQUESTS)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]
    eng = _engine(cfg, params, kw)
    for p in prompts:
        eng.add_request(p, N_NEW)
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dec = [1e3 * t for t in eng.decode_step_times]
    return dict(tokens_per_s=eng.tokens_generated / wall, wall_s=wall,
                decode_steps=len(dec),
                decode_step_ms_median=float(np.median(dec)),
                decode_step_ms_p90=float(np.percentile(dec, 90)),
                prefill_ms_median=float(np.median(
                    [1e3 * t for _, t in eng.prefill_times])))


def _wrapper_us(torch, np):
    """Host microseconds a call: paged decode at the decode step's shape
    (b8, 16 kv heads, d64, 72 pages of 128) over a bf16 and an e4m3 pool,
    and the flash forward (under ``no_grad``, as prefill calls it) at b1
    h16 s512 d64 causal with padding segment ids."""
    from apex_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def per_call(fn, calls=200, rounds=10):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return float(np.median(out))

    q = rnd(8, 16, 1, 64)
    kp, vp = rnd(16, 72, 128, 64), rnd(16, 72, 128, 64)
    bt = torch.arange(1, 65, dtype=torch.int32, device="cuda").reshape(8, 8)
    sl = torch.tensor([0, 1, 127, 128, 129, 300, 640, 1024],
                      dtype=torch.int32, device="cuda")
    ks = torch.ones(16, 72, device="cuda")
    k8, v8 = kp.to(torch.float8_e4m3fn), vp.to(torch.float8_e4m3fn)
    qs = rnd(1, 16, 512, 64)
    sid = torch.where(torch.arange(512, device="cuda") < 400, 0, -1).to(
        torch.int32)[None]
    with torch.no_grad():
        return {
            "paged_decode bf16": per_call(
                lambda: fa.paged_decode_attention(q, kp, vp, bt, sl)),
            "paged_decode e4m3": per_call(
                lambda: fa.paged_decode_attention(q, k8, v8, bt, sl,
                                                  k_scales=ks,
                                                  v_scales=ks)),
            "flash_attention s512": per_call(
                lambda: fa.flash_attention(qs, qs, qs, sid, sid,
                                           causal=True)),
        }


def main() -> int:
    args = _args()
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(args.root or os.path.join(here, "..", ".."))
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_times: no CUDA device", file=sys.stderr)
        return 2
    from apex_tpu_torch.ops import _build
    _build.build_all([_build.dtype_target("flash_fwd", 0),
                      _build.dtype_target("paged_decode", 0), "fp8_matmul"])
    if args.build_only:
        return 0
    from apex_tpu_torch.models.gpt import GPT, GPTConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(vocab_size=32768, max_seq_len=1024, hidden_size=1024,
                    num_layers=12, num_heads=16, dtype=torch.bfloat16)
    params = GPT.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    res = {"root": root, "card": _card(), "torch": torch.__version__,
           "engines": {}}
    if args.wrappers:
        res["wrapper_host_us_per_call"] = _wrapper_us(torch, np)
    for name in args.engines.split(","):
        kw = ENGINES[name]
        warm = _engine(cfg, params, kw)
        warm.add_request(list(range(1, 65)), 6)
        warm.run()
        del warm
        torch.cuda.synchronize()
        res["engines"][name] = [_drain(torch, np, cfg, params, kw)
                                for _ in range(args.reps)]
    text = json.dumps(res)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
