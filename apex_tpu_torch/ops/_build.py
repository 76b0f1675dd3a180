"""Builds the port's CUDA sources and loads them with ``ctypes``.

Each ``apex_tpu_torch/csrc/<name>.cu`` exposes a plain C interface (no
PyTorch headers, so ``nvcc`` takes seconds, not minutes) and is compiled on
first use into ``build/apex_tpu_torch/lib<name>-<hash>.so`` at the root of
the checkout::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>-<hash>.so <name>.cu

The hash is of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and a stale library is never
loaded. Nothing here runs at import: the first CUDA
launch of a kernel calls :func:`load`. :func:`build_all` starts one
``nvcc`` per source at once, for callers that want every kernel ready
before they time anything.

A source that instantiates its kernels for bf16, fp16 and fp32 operands
(:data:`DTYPE_SPLIT`) is built as three targets, ``<name>@bf16``,
``<name>@f16`` and ``<name>@f32``, each compiled with ``-DAPEX_DTYPE=<code>``
so that it holds one dtype's kernels (``csrc/frag.cuh``'s
``APEX_HAS_DTYPE``): the three compile side by side instead of one after
the other. Wrappers name the target of their operands' dtype
(:func:`dtype_target`).

Every C entry point returns the ``cudaError_t`` of its launch; wrappers pass
the result to :func:`check` and raise on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "apex_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: the build log (kept beside the library as ``.log``) lists
# each kernel's registers, shared memory and spills
FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                      "-lineinfo", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

# sources built once per operand dtype; the dtype codes of the C interfaces
DTYPE_SPLIT = ("flash_fwd", "flash_bwd", "lm_head_ce", "paged_decode")
DTYPE_VARIANTS = ("bf16", "f16", "f32")          # codes 0, 1, 2


def dtype_target(name: str, code: int) -> str:
    """The build target of source ``name`` for dtype code ``code``."""
    return f"{name}@{DTYPE_VARIANTS[code]}"


def targets(names: Iterable[str]) -> List[str]:
    """``names`` with every :data:`DTYPE_SPLIT` source expanded into its
    three dtype targets."""
    out = []
    for n in names:
        if n in DTYPE_SPLIT:
            out += [dtype_target(n, c) for c in range(len(DTYPE_VARIANTS))]
        else:
            out.append(n)
    return out


def _source_and_defines(target: str):
    name, _, variant = target.partition("@")
    defines = ([f"-DAPEX_DTYPE={DTYPE_VARIANTS.index(variant)}"]
               if variant else [])
    return SRC_DIR / f"{name}.cu", defines


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels are built from "
            f"{SRC_DIR} on the machine that runs them")
    return found


def library_path(target: str) -> Path:
    """The library's path, keyed by the source, the shared headers
    (``csrc/*.cuh``), the flags and the target's defines."""
    src, defines = _source_and_defines(target)
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS + defines).encode())
    stem = target.replace("@", "-")
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def nvcc_command(target: str, out: Path) -> List[str]:
    src, defines = _source_and_defines(target)
    return [nvcc_path(), *FLAGS, *defines, "-o", str(out), str(src)]


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    ``(final_path, tmp_path, Popen | None)``."""
    out = library_path(name)
    if out.is_file():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(nvcc_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)          # atomic: a reader never sees half a file


def build_all(names: Iterable[str]) -> None:
    """Compile every named source at once, one ``nvcc`` process each."""
    names = list(names)
    started = [(n, *_start(n)) for n in names]
    try:
        for n, out, tmp, proc in started:
            _finish(n, out, tmp, proc)
    finally:
        for _, _, _, proc in started:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C function ``symbol`` of ``csrc/<name>.cu`` with its argument types
    declared (``c_void_p`` for every pointer and the stream, so ctypes
    never cuts a pointer to 32 bits) and an ``int`` (``cudaError_t``)
    result."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
