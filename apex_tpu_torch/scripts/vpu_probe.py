"""Per-op cost probe on the card (``scripts/vpu_probe.py`` of the JAX
package): the time of REPS = 64 chained applications of one elementwise
fp32 op to every element of x [grid, 512, 512], chained ``scan_len`` times
and then summed.

- :func:`vpu_probe_kernel` — one application of the probe to x: on CUDA the
  kernel ``csrc/vpu_probe.cu``, which replaces the Pallas kernel
  ``make_kernel(op)`` (``scripts/vpu_probe.py:17``, launched by ``probe``
  ``:41``); on the CPU :func:`vpu_probe_reference`, the plain torch loop
  of the same op. ``vpu_probe_kernel.launches`` counts kernel launches.
- :func:`probe` — the script's measurement: the kernel chained
  ``scan_len`` times, then summed; the median of 5 timed windows after one
  warm-up, printed as ms, ns per element-op and G element-ops per second.
- :func:`bounds` — what the card could do at best: the bytes of one launch
  over the HBM rate, and its element-ops over the card's fp32 issue rate
  (``mul``, ``max``, ``where``, ``iota_cmp_where``) or its special-function
  rate (``exp``, ``exp2``), from the SM count and clock the device reports.

The TPU kernel's premise — no HBM traffic — does not hold on a GPU (the
source says why): each launch reads and writes x, so the cheap ops are
bound by bytes and the probe records which bound applies to each op.

Run on a machine with a CUDA card::

    python -m apex_tpu_torch.scripts.vpu_probe
"""

from __future__ import annotations

import ctypes
import subprocess
import time

import numpy as np
import torch

from apex_tpu_torch._compat import check_device_type
from apex_tpu_torch.ops import _build

REPS = 64
BQ, BK = 512, 512
OPS = ("mul", "max", "where", "iota_cmp_where", "exp", "exp2")
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
FP32_LANES_PER_SM = 128              # fp32 FMA lanes of a Hopper SM
SFU_PER_SM = 16                      # ex2 results per clock of a Hopper SM
_SFU_OPS = ("exp", "exp2")


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d fp32 constant on ``like``'s device: the JAX kernel's weakly
    typed Python scalars are fp32 values."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def vpu_probe_reference(x: torch.Tensor, op: str) -> torch.Tensor:
    """The plain version: REPS applications of ``op`` to fp32 ``x``
    [grid, 512, 512], in the JAX kernel's order."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}: one of {OPS}")
    acc = x
    if op == "iota_cmp_where":
        rows = torch.arange(BQ, device=x.device)[:, None]
        cols = torch.arange(BK, device=x.device)[None, :]
        lower = rows >= cols
    c = {"mul": 1.0000001, "max": 0.999999, "exp": 1e-9, "exp2": 1e-9}.get(
        op, 0.999)
    c = _const(c, x)
    for _ in range(REPS):
        if op == "mul":
            acc = acc * c
        elif op == "max":
            acc = torch.maximum(acc, acc * c)
        elif op == "where":
            acc = torch.where(acc > 0, acc, acc * c)
        elif op == "iota_cmp_where":
            acc = torch.where(lower, acc, acc * c)
        elif op == "exp":
            acc = torch.exp(acc * c)
        else:
            acc = torch.exp2(acc * c)
    return acc


# apex_vpu_probe(x, out, n, op, stream)
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
         ctypes.c_void_p]


def _probe_cuda(x: torch.Tensor, op: str) -> torch.Tensor:
    what = "vpu_probe kernel"
    if op not in OPS:
        raise ValueError(f"{what}: unknown op {op!r}: one of {OPS}")
    if (x.dtype != torch.float32 or x.dim() != 3
            or tuple(x.shape[1:]) != (BQ, BK) or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError(f"{what}: takes a contiguous, 16-byte aligned "
                         f"float32 [grid, {BQ}, {BK}] tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x)
    fn = _build.function("vpu_probe", "apex_vpu_probe", _ARGS)
    err = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
             x.numel(), OPS.index(op),
             ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(err, what)
    vpu_probe_kernel.launches += 1
    return out


def vpu_probe_kernel(x: torch.Tensor, op: str) -> torch.Tensor:
    """One application of the probe: the kernel on CUDA,
    :func:`vpu_probe_reference` on the CPU."""
    if check_device_type(x, "vpu_probe_kernel") == "cpu":
        return vpu_probe_reference(x, op)
    return _probe_cuda(x, op)


vpu_probe_kernel.launches = 0


def sm_clock_hz(device=0) -> float:
    """The SM clock the device reports (``clock_rate`` of the device
    properties where torch has it, else ``nvidia-smi``'s maximum SM
    clock)."""
    props = torch.cuda.get_device_properties(device)
    khz = getattr(props, "clock_rate", None)
    if khz:
        return float(khz) * 1e3
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[device]) * 1e6


def bounds(op: str, grid: int = 64, device=0) -> dict:
    """Least time of ONE launch at ``grid``: its bytes (x read, out written)
    at the HBM rate and its REPS * elements ops at the op's issue rate;
    ``bound_by`` names the larger."""
    props = torch.cuda.get_device_properties(device)
    n = grid * BQ * BK
    clock = sm_clock_hz(device)
    per_sm = SFU_PER_SM if op in _SFU_OPS else FP32_LANES_PER_SM
    rate = props.multi_processor_count * per_sm * clock
    bytes_ms = 2 * 4 * n / HBM_BYTES_PER_S * 1e3
    ops_ms = REPS * n / rate * 1e3
    return dict(bytes_ms=bytes_ms, ops_ms=ops_ms,
                issue="sfu" if op in _SFU_OPS else "fp32",
                rate_per_s=rate, sm_clock_hz=clock,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def probe(op: str, grid: int = 64, scan_len: int = 16) -> dict:
    """The script's ``probe``: ``scan_len`` chained launches then a sum,
    timed on the card (median of 5 windows after a warm-up)."""
    x = torch.from_numpy(np.random.randn(grid, BQ, BK).astype(
        np.float32)).cuda()

    def g(c):
        for _ in range(scan_len):
            c = vpu_probe_kernel(c, op)
        return float(c.sum())

    g(x)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g(x)
        times.append(time.perf_counter() - t0)
    med = sorted(times)[2]
    n = grid * REPS * BQ * BK * scan_len
    res = dict(op=op, ms=med * 1e3, ns_per_elem=med / n * 1e9,
               gelem_per_s=n / med / 1e9, launches=scan_len)
    print(f"{op:16s} {med * 1e3:8.2f} ms   {res['ns_per_elem']:7.4f} "
          f"ns/elem ({res['gelem_per_s']:6.1f} Gelem/s)", flush=True)
    return res


if __name__ == "__main__":
    for name in OPS:
        probe(name)
