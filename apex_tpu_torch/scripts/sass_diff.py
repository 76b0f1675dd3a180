"""The SASS of the flash kernels of this checkout against another
checkout's, function by function.

Builds this checkout's ``flash_fwd_sm90`` and ``flash_bwd_sm90`` targets
(bf16 and fp16, ``ops/_build.py``) and the fp32 targets of ``flash_fwd``
and ``flash_bwd`` (the FFMA kernels and frag.cuh's), compiles the other
checkout's sources of the same names with the same flags beside them, disassembles both with
``cuobjdump -sass`` and compares each kernel present in both by its
instructions (addresses and encodings stripped). Needs ``nvcc`` and
``cuobjdump``, no card. Run from this checkout's root::

    python3 apex_tpu_torch/scripts/sass_diff.py --other PATH [--out DIR]

It prints one JSON line: the kernels whose SASS is equal, those that differ,
those only this checkout has and those only the other has; it exits 1 when
a kernel differs or is gone.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from apex_tpu_torch.ops import _build  # noqa: E402

# (source, dtype codes): the wgmma sources in both of their dtypes, the
# others in fp32
SOURCES = (("flash_fwd_sm90", (0, 1)), ("flash_bwd_sm90", (0, 1)),
           ("flash_fwd", (2,)), ("flash_bwd", (2,)))
CODES = {0: "bf16", 1: "f16", 2: "f32"}


# the anonymous namespace's name in a mangled name: a hash of the source
# file, so it differs between checkouts
_ANON = re.compile(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_[0-9a-f]{8}(?=\d)")


def _sass(lib: Path) -> dict:
    """Each function's instructions, without addresses or encodings, by
    its mangled name with the anonymous namespace's name taken out."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _ANON.sub("_ZN_anon_", m.group(1))
            funcs[name] = []
        elif name:
            # the instruction alone: no address or encoding comments, and
            # single spaces (cuobjdump aligns the comments to the longest
            # instruction in the file, so another kernel moves them)
            ins = " ".join(_ANON.sub("_ZN_anon_", re.sub(
                r"/\*[^*]*\*/", "", line)).split())
            if ins:
                funcs[name].append(ins)
    return funcs


def _other_lib(other: Path, src: str, code: int, out: Path) -> Path:
    lib = out / f"other_{src}_{CODES[code]}.so"
    cmd = [_build.nvcc_path(), *_build.FLAGS, f"-DAPEX_DTYPE={code}",
           "-o", str(lib), str(other / "apex_tpu_torch" / "csrc" / f"{src}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=1200)
    if res.returncode:
        raise RuntimeError(f"nvcc {src} ({CODES[code]}): {res.stderr[-2000:]}")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the checkout to compare against")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "sass_diff",
                    help="where the other checkout's libraries are built")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    jobs = [(s, c) for s, codes in SOURCES for c in codes]
    targets = [f"{s}@{CODES[c]}" for s, c in jobs]
    with ThreadPoolExecutor(len(jobs) + 1) as ex:
        mine = ex.submit(_build.build_all, targets)
        others = list(ex.map(lambda j: _other_lib(args.other.resolve(), *j,
                                                  args.out), jobs))
        mine.result()
    report = dict(equal=[], differ=[], new=[], gone=[])
    for target, other in zip(targets, others):
        a, b = _sass(_build.library_path(target)), _sass(other)
        for name in sorted(set(a) | set(b)):
            key = f"{target} {name}"
            if name not in b:
                report["new"].append(key)
            elif name not in a:
                report["gone"].append(key)
            else:
                report["equal" if a[name] == b[name] else "differ"].append(key)
    print(json.dumps({**{k: len(v) for k, v in report.items()},
                      "differ_names": report["differ"],
                      "new_names": report["new"],
                      "gone_names": report["gone"]}), flush=True)
    return 1 if report["differ"] or report["gone"] else 0


if __name__ == "__main__":
    sys.exit(main())
