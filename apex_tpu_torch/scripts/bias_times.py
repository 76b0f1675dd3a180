"""Times the wgmma route's bias variants of this checkout against another
checkout's, on one card in one process.

The flash forward (B1), the single pass (B2) and the split's dk/dv (B3)
and dq (B4), each with the additive bias and with the bias and attention
dropout together, in bf16 at the shapes of the main paths that run them:
train-mha18's b16 h16 s512 d64 (the future mask as the bias, key padding
of 384-512 tokens), train-mha16's b1 h8 s3072 d128 (the future mask) and
train-mha6's b28 h16 s128 d64 (the future mask, key padding of 96-128
tokens), dropout 0.1. The other checkout's ``flash_fwd_sm90`` and
``flash_bwd_sm90`` sources are compiled with this checkout's flags
(``ops/_build.py``) and loaded in place of this checkout's libraries, so
both versions run behind the same wrappers (their C entries take the same
arguments); the versions are timed in turns, other, this, this, other,
each call by CUDA events after an L2 flush and a device sleep (device time
only). Run from this checkout's root on a machine with a CUDA card::

    python3 apex_tpu_torch/scripts/bias_times.py --other PATH [--out FILE]

It prints one JSON line: the card, and each case's times in ms by version
in the order they ran.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from apex_tpu_torch.ops import _build  # noqa: E402
from apex_tpu_torch.scripts.sass_diff import _other_lib  # noqa: E402

SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90")
RATE, SEED = 0.1, 20261024


def _cases(torch, fa):
    """``(name, fn)`` of each timed call, on operands made here."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=bf)

    def future(s):
        return torch.triu(torch.full((s, s), float("-inf"), device="cuda"),
                          1)[None, None]

    def padding(b, s, lo, seed):
        lens = torch.randint(lo, s + 1, (b,), generator=torch.Generator()
                             .manual_seed(seed)).cuda()
        sid_kv = torch.where(torch.arange(s, device="cuda")[None]
                             < lens[:, None], 0, -1).to(torch.int32)
        return torch.zeros(b, s, dtype=torch.int32, device="cuda"), sid_kv

    drop = fa._dropout_args(RATE, SEED)
    cases = []
    for what, (b, h, s, d), lo in (("mha18 b16 h16 s512 d64", (16, 16, 512,
                                                              64), 384),
                                   ("mha16 b1 h8 s3072 d128", (1, 8, 3072,
                                                               128), None),
                                   ("mha6 b28 h16 s128 d64", (28, 16, 128,
                                                              64), 96)):
        q, k, v, do = (rnd(b, h, s, d) for _ in range(4))
        bias = future(s)
        sids = padding(b, s, lo, s) if lo else (None, None)
        scale = d ** -0.5
        out, lse = fa.flash_attention_fwd(q, k, v, *sids, False, scale,
                                          bias=bias)
        delta = (do.float() * out.float()).sum(-1)
        bop = fa._bias_operand(bias, b, h, s, s, q.device, scale)
        dq_acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
        args = (q, k, v, do, lse, delta, *sids, False, scale, fa._NO_ROUNDS)
        for tag, dr, kw in (("bias", (0, 0, 1.0), {}),
                            ("bias+dropout", drop,
                             dict(dropout_rate=RATE, dropout_seed=SEED))):
            cases.append((f"B1 {tag} {what}", lambda q=q, k=k, v=v, s_=sids,
                          sc=scale, bi=bias, kw=kw: fa.flash_attention_fwd(
                              q, k, v, *s_, False, sc, bias=bi, **kw)))
            if what.startswith("mha16"):
                cases.append((f"B3 {tag} {what}", lambda a=args, dr=dr,
                              bo=bop: fa._flash_dkdv_cuda(*a, dropout=dr,
                                                          bias=bo)))
                cases.append((f"B4 {tag} {what}", lambda a=args, dr=dr,
                              bo=bop: fa._flash_dq_cuda(*a, dropout=dr,
                                                        bias=bo)))
            else:
                cases.append((f"B2 {tag} {what}", lambda a=args, acc=dq_acc,
                              dr=dr, bo=bop: fa._flash_bwd_fused_cuda(
                                  *a[:10], acc, None, dr, bo)))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the checkout to compare against")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON line here")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bias_times: no CUDA device", file=sys.stderr)
        return 2
    from apex_tpu_torch.ops import flash_attention as fa
    targets = [f"{s}@bf16" for s in SOURCES]
    build = ROOT / "build" / "bias_times"
    build.mkdir(parents=True, exist_ok=True)
    _build.build_all(targets)
    libs = {"this": {t: _build.load(t) for t in targets},
            "other": {f"{s}@bf16": ctypes.CDLL(str(_other_lib(
                args.other.resolve(), s, 0, build))) for s in SOURCES}}
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def timed(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ev = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(300_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            ev.append((a, b))
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(b) for a, b in ev]))

    cases = _cases(torch, fa)
    res = {name: {"other": [], "this": []} for name, _ in cases}
    for version in ("other", "this", "this", "other"):
        _build._LIBS.update(libs[version])
        for name, fn in cases:
            res[name][version].append(timed(fn))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    line = json.dumps({"card": card, "order": "other, this, this, other",
                       "ms": res})
    print(line, flush=True)
    if args.out:
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
