"""Per-block timeline of the fused bottleneck kernel (B15) on a CUDA card.

A copy of ``csrc/bottleneck.cu`` is built with ``%globaltimer`` stamps
patched in after each stage of the two consumer warpgroups (thread 0 of
each, one row of stamps a band, the first 16 bands of each block), run
once at N images after warm-up calls (L2 flushed before the timed call),
and the stamps are read back. Printed: the stamps a band averaged over the
blocks (µs from the first stamp) and the mean duration of each stage, as
one JSON object (also written to ``--out``), beside the card's name and
power limit. The copy must produce the library's output bitwise, which is
checked.

Stages, warpgroup 0 (phases 1 and 2): band start, phase 1 done (its wait
for the x boxes included), phase 1's epilogue done, phase 2 done, h2 free
(the wait for warpgroup 1), h2 handed over. Warpgroup 1 (phase 3): h2
received, h2 in registers and freed, the four chunks' epilogues and stores
done, the last box read by its store.

Run on a machine with a CUDA card, from the root of a checkout::

    python3 apex_tpu_torch/scripts/bottleneck_timeline.py [--n 32] [--out F]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

_HEAD = '''
__device__ unsigned long long g_tl[132 * 16 * 16];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}
#define STAMP(s, k) do { if ((s) < 16 && blockIdx.x < 132) \\
    g_tl[(blockIdx.x * 16 + (s)) * 16 + (k)] = gtime(); } while (0)
'''

# (anchor in csrc/bottleneck.cu, text that replaces it): each anchor must
# occur once
_PATCHES = (
    ("namespace {\n\nusing bf16", _HEAD + "namespace {\n\nusing bf16"),
    ("        mbar_wait(&wbar[0], 0);\n        const int first",
     "        if (t == 0 && b >= 0) STAMP(count, 0);\n"
     "        mbar_wait(&wbar[0], 0);\n        const int first"),
    ("        wgmma_wait<0>();\n        wg::fence_regs(acc);\n"
     "        phase1_epilogue(acc, h1, empty, first, vG1, vB1, Y, x0, b >= 0,"
     " t);\n",
     "        wgmma_wait<0>();\n        if (t == 0 && b >= 0) STAMP(count, 1);"
     "\n        wg::fence_regs(acc);\n"
     "        phase1_epilogue(acc, h1, empty, first, vG1, vB1, Y, x0, b >= 0,"
     " t);\n        if (t == 0 && b >= 0) STAMP(count, 2);\n"),
    ("        phase2_issue(acc, h1, sW2);\n        wgmma_wait<0>();\n",
     "        phase2_issue(acc, h1, sW2);\n        wgmma_wait<0>();\n"
     "        if (t == 0) STAMP(count, 3);\n"),
    ("        if (count > 0) mbar_wait(h2_empty, (count - 1) & 1);\n",
     "        if (count > 0) mbar_wait(h2_empty, (count - 1) & 1);\n"
     "        if (t == 0) STAMP(count, 4);\n"),
    ("        if (t == 0) mbar_arrive(h2_full);\n",
     "        if (t == 0) mbar_arrive(h2_full);\n"
     "        if (t == 0) STAMP(count, 5);\n"),
    ("      mbar_wait(h2_full, count & 1);\n",
     "      mbar_wait(h2_full, count & 1);\n"
     "      if (t == 0) STAMP(count, 6);\n"),
    ("      if (t == 0) mbar_arrive(h2_empty);",
     "      if (t == 0) STAMP(count, 7);\n"
     "      if (t == 0) mbar_arrive(h2_empty);"),
    ("      if (t == 0) {\n        wg::bulk_wait_read<0>();\n"
     "        mbar_arrive(&res_empty[3]);\n      }\n",
     "      if (t == 0) STAMP(count, 8);\n"
     "      if (t == 0) {\n        wg::bulk_wait_read<0>();\n"
     "        mbar_arrive(&res_empty[3]);\n      }\n"
     "      if (t == 0) STAMP(count, 9);\n"),
)
_TAIL = '''
extern "C" int apex_bottleneck_timeline(void* dst) {
  return cudaMemcpyFromSymbol(dst, g_tl, sizeof(g_tl));
}
extern "C" int apex_bottleneck_timeline_zero() {
  static unsigned long long z[132 * 16 * 16];
  return cudaMemcpyToSymbol(g_tl, z, sizeof(z));
}
'''
STAGES = ("wg0 band start", "phase 1 done", "phase 1 epilogue done",
          "phase 2 done", "h2 free", "h2 handed over", "wg1 h2 received",
          "h2 in registers", "epilogues and stores done", "last box read")
# the mean durations reported: (name, from stage, to stage)
SPANS = (("phase 1 (with its x wait)", 0, 1),
         ("phase 1 epilogue", 1, 2),
         ("phase 2", 2, 3),
         ("wait for warpgroup 1 (h2 free)", 3, 4),
         ("phase 2 epilogue and hand-over", 4, 5),
         ("h2 to registers", 6, 7),
         ("phase 3: products, epilogues, stores", 7, 8),
         ("last store read", 8, 9))


def patched_source(root: str) -> str:
    with open(os.path.join(root, "apex_tpu_torch", "csrc",
                           "bottleneck.cu")) as f:
        s = f.read()
    for old, new in _PATCHES:
        if s.count(old) != 1:
            raise RuntimeError("bottleneck_timeline: an anchor is missing "
                               f"from csrc/bottleneck.cu: {old!r}")
        s = s.replace(old, new)
    return s + _TAIL


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32, help="images")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        ".."))
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bottleneck_timeline: no CUDA device", file=sys.stderr)
        return 2
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.scripts import bottleneck_proto as bp

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "bottleneck_timeline.cu")
        with open(src, "w") as f:
            f.write(patched_source(root))
        so = os.path.join(tmp, "libbottleneck_timeline.so")
        subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-I",
                        str(_build.SRC_DIR), "-o", so, src], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(so)
    fn = lib.apex_bottleneck
    fn.argtypes = bp._ARGS
    fn.restype = ctypes.c_int
    p = bp.make_params(device="cuda")
    x = bp.make_input(args.n, device="cuda")
    ref = bp.fused_block(x, p)
    out = torch.empty_like(x)
    plan = bp.bottleneck_plan(args.n, bp._sm_count(x.device))

    def run():
        err = fn(*(ctypes.c_void_p(t.data_ptr())
                   for t in [x] + [p[k] for k in bp.PARAM_NAMES] + [out]),
                 args.n, plan.grid, plan.seg_bands, plan.smem_bytes,
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        _build.check(err, "bottleneck timeline copy")

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    _build.check(lib.apex_bottleneck_timeline_zero(), "timeline reset")
    flush.zero_()
    run()
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise RuntimeError("bottleneck_timeline: the stamped copy's output "
                           "differs from the library's")
    buf = np.zeros(132 * 16 * 16, dtype=np.uint64)
    _build.check(lib.apex_bottleneck_timeline(
        buf.ctypes.data_as(ctypes.c_void_p)), "timeline read")
    tl = buf.reshape(132, 16, 16)[:plan.grid, :, :len(STAGES)].astype(
        np.float64)
    t0 = tl[tl > 0].min()
    rel = np.where(tl > 0, (tl - t0) / 1e3, np.nan)       # µs
    bands = min(16, plan.seg_bands * -(-plan.units // plan.grid))
    by_band = [[round(float(v), 3) for v in np.nanmean(rel[:, b, :], axis=0)]
               for b in range(bands)]
    spans = {name: round(float(np.nanmean(rel[:, :bands, b]
                                          - rel[:, :bands, a])), 3)
             for name, a, b in SPANS}
    spans["warpgroup 0 band period"] = round(float(np.nanmean(
        rel[:, 1:bands, 0] - rel[:, :bands - 1, 0])), 3)
    spans["warpgroup 1 band period"] = round(float(np.nanmean(
        rel[:, 1:bands, 6] - rel[:, :bands - 1, 6])), 3)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    res = dict(card=card, n=args.n, plan=dict(vars(plan)), stages=STAGES,
               us_by_band=by_band, mean_us=spans,
               end_us=round(float(np.nanmax(rel)), 3))
    text = json.dumps(res)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
