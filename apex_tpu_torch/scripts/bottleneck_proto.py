"""ResNet-50's conv2_x bottleneck in one kernel on the card, against its
plain version and the cuDNN composition (``scripts/bottleneck_proto.py`` of
the JAX package).

Shape, the proto's: x [N, 56, 56, 256] NHWC bf16, batch norms folded to a
scale and a shift::

    x -> 1x1 w1 [256, 64] -> *g1 + b1 -> relu
      -> 3x3 w2 [3, 3, 64, 64] (SAME) -> *g2 + b2 -> relu
      -> 1x1 w3 [64, 256] -> *g3 + b3 -> + x -> relu

- :func:`make_params` — the proto's parameters: the same ``RandomState``
  draws, rounded to bf16, so the port's weights are the proto's numbers;
- :func:`plain_block` — the counterpart of the proto's ``xla_block``:
  fp32 products of the (bf16) operands, h1 and h2 rounded to the input's
  dtype, the residual added in fp32, one rounding at the end;
- :func:`fused_block` — the counterpart of ``pallas_block``: on CUDA the
  kernel ``csrc/bottleneck.cu``, which replaces the Pallas ``_kernel``
  (``scripts/bottleneck_proto.py:89``, launched at ``:157``), on the CPU
  :func:`plain_block`; ``fused_block.launches`` counts kernel launches;
- :func:`bottleneck_plan` — the kernel's schedule and shared-memory budget
  in Python (grid, segment length), which the wrapper launches with;
  :func:`plan_schedule` lists what a block loads and computes, in order;
- :func:`cudnn_block` — the library composition timed beside the kernel:
  three ``F.conv2d`` in ``channels_last`` bf16 with the folded batch norms
  and ReLUs as bf16 elementwise ops;
- :func:`timed` — milliseconds per block (CUDA events around ``k``
  back-to-back blocks, median of 5 windows).

Run on a machine with a CUDA card::

    python -m apex_tpu_torch.scripts.bottleneck_proto
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch._compat import DeviceLike, check_device_type, resolve_device
from apex_tpu_torch.ops import _build

N, H, W, C, S = 32, 56, 56, 256, 64     # batch, spatial, channels, squeeze
PARAM_NAMES = ("w1", "w2", "w3", "g1", "b1", "g2", "b2", "g3", "b3")


def make_params(dtype=torch.bfloat16, seed: int = 0,
                device: DeviceLike = None):
    """The proto's parameters, from the same ``RandomState(seed)`` draws in
    the same order: w1 [C, S], w2 [3, 3, S, S] (HWIO), w3 [S, C] and the
    folded batch-norm vectors g1, b1, g2, b2 [S], g3, b3 [C]; on ``device``
    (CUDA by default)."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    p = {
        "w1": rng.randn(C, S) * (2.0 / C) ** 0.5,
        "w2": rng.randn(3, 3, S, S) * (2.0 / (9 * S)) ** 0.5,
        "w3": rng.randn(S, C) * (2.0 / S) ** 0.5,
        "g1": 1.0 + 0.1 * rng.randn(S), "b1": 0.1 * rng.randn(S),
        "g2": 1.0 + 0.1 * rng.randn(S), "b2": 0.1 * rng.randn(S),
        "g3": 1.0 + 0.1 * rng.randn(C), "b3": 0.1 * rng.randn(C),
    }
    return {k: torch.from_numpy(v).to(dtype).to(device)
            for k, v in p.items()}


def make_input(n: int = N, seed: int = 1, dtype=torch.bfloat16,
               device: DeviceLike = None):
    """The proto's input: ``RandomState(seed).randn(n, H, W, C) * 0.5``, on
    ``device`` (CUDA by default)."""
    device = resolve_device(device)
    x = np.random.RandomState(seed).randn(n, H, W, C) * 0.5
    return torch.from_numpy(x).to(dtype).to(device)


def _bn_relu(h, g, b, dtype):
    return torch.relu(h * g.float() + b.float()).to(dtype)


def plain_block(x, p):
    """The plain version (the proto's ``xla_block``): x [n, 56, 56, 256]
    NHWC -> the block's output in ``x.dtype``."""
    dtype = x.dtype
    h = torch.einsum("nhwc,cs->nhws", x.float(), p["w1"].float())
    h = _bn_relu(h, p["g1"], p["b1"], dtype)
    h = F.conv2d(h.float().permute(0, 3, 1, 2),
                 p["w2"].float().permute(3, 2, 0, 1), padding=1)
    h = _bn_relu(h.permute(0, 2, 3, 1), p["g2"], p["b2"], dtype)
    h = torch.einsum("nhws,sc->nhwc", h.float(), p["w3"].float())
    h = h * p["g3"].float() + p["b3"].float()
    return torch.relu(h + x.float()).to(dtype)


# The fused kernel's schedule (csrc/bottleneck.cu mirrors it). An image is
# cut into STRIPS column strips of STRIP output columns, each strip into
# BANDS bands of BAND output rows; a unit of work is a segment of
# ``seg_bands`` consecutive bands of one strip. A block loads the weights
# once, then walks its units (block b: units b, b + grid, ...); each unit
# starts with one phase-1-only step (the h1 rows above its first band) and
# then, band by band, computes BAND new h1 rows over the strip's HALO_W
# columns and the band's output.
BAND, STRIP = 4, 14
HALO_W = STRIP + 2
STRIPS, BANDS = W // STRIP, H // BAND
SMS = 132                                 # the H100's SMs
X_STAGES = 4
SMEM_LIMIT = 232_448                      # shared memory a block may use
# the kernel's shared memory, in its order (bytes)
SMEM_LAYOUT = (
    ("w1", C * S * 2), ("w2", 9 * S * S * 2), ("w3", S * C * 2),
    ("x ring", X_STAGES * BAND * HALO_W * 64 * 2),
    ("residual/output", BAND * STRIP * C * 2),
    ("h1 window", 8 * (6 * HALO_W + 8) * 16),
    ("h2", BAND * HALO_W * S * 2),
    ("folded vectors", (4 * S + 2 * C) * 4),
    ("barriers", 256), ("alignment slack", 1024))
SMEM_BYTES = sum(b for _, b in SMEM_LAYOUT)


@dataclass(frozen=True)
class Plan:
    n: int
    grid: int            # blocks, at most one an SM
    seg_bands: int       # bands a unit
    segs: int            # units a strip
    units: int
    smem_bytes: int


def bottleneck_plan(n: int, sms: int = SMS) -> Plan:
    """The launch of ``n`` images on ``sms`` SMs: the segment length whose
    slowest block runs the fewest steps (a band counting 2, a unit's
    phase-1-only first step 1), longer segments on a tie (less
    recompute); the grid is ``min(sms, units)``."""
    if n < 1:
        raise ValueError(f"bottleneck_plan: n must be >= 1, got {n}")
    best = None
    for seg in range(BANDS, 0, -1):
        segs = -(-BANDS // seg)
        units = n * STRIPS * segs
        grid = min(sms, units)
        cost = -(-units // grid) * (2 * seg + 1)
        if best is None or cost < best[0]:
            best = (cost, Plan(n, grid, seg, segs, units, SMEM_BYTES))
    return best[1]


def plan_units(plan: Plan, block: int):
    """(image, strip, first band, bands) of each unit of ``block``, in the
    order it runs them."""
    out = []
    for u in range(block, plan.units, plan.grid):
        img, rest = divmod(u, STRIPS * plan.segs)
        strip, seg = divmod(rest, plan.segs)
        first = seg * plan.seg_bands
        out.append((img, strip, first, min(plan.seg_bands, BANDS - first)))
    return out


def plan_schedule(plan: Plan, block: int):
    """What ``block`` does, in order: ``("weights", name)`` for each weight
    it loads (the kernel issues w2 and w3 after the first step's x boxes),
    ``("h1", image, strip, first row)`` for each phase-1 product
    (BAND h1 rows from ``first row`` over the strip's HALO_W columns, rows
    outside the image zero), ``("tile", image, strip, band)`` for each
    output band it computes."""
    ev = [("weights", name) for name in ("w1", "w2", "w3")]
    for img, strip, first, bands in plan_units(plan, block):
        for b in range(first - 1, first + bands):
            ev.append(("h1", img, strip, b * BAND + 1))
            if b >= first:
                ev.append(("tile", img, strip, b))
    return ev


def recompute_ratio(plan: Plan) -> float:
    """h1 pixels phase 1 computes over output pixels (the halo's share)."""
    h1 = sum(e[0] == "h1" for b in range(plan.grid)
             for e in plan_schedule(plan, b)) * BAND * HALO_W
    return h1 / (plan.n * H * W)


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# apex_bottleneck(x, w1, w2, w3, g1, b1, g2, b2, g3, b3, out, n, grid,
#                 seg_bands, smem, stream)
_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SHAPES = {"w1": (C, S), "w2": (3, 3, S, S), "w3": (S, C), "g1": (S,),
           "b1": (S,), "g2": (S,), "b2": (S,), "g3": (C,), "b3": (C,)}


def _fused_cuda(x, p):
    what = "bottleneck kernel"
    if x.dim() != 4 or tuple(x.shape[1:]) != (H, W, C):
        raise ValueError(f"{what}: x must be [n, {H}, {W}, {C}] NHWC, got "
                         f"{tuple(x.shape)}")
    for name, t in [("x", x)] + [(k, p[k]) for k in PARAM_NAMES]:
        if name != "x" and tuple(t.shape) != _SHAPES[name]:
            raise ValueError(f"{what}: {name} must be {_SHAPES[name]}, got "
                             f"{tuple(t.shape)}")
        if (t.dtype != torch.bfloat16 or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} must be a contiguous, 16-byte "
                             f"aligned bfloat16 tensor on {x.device}, got "
                             f"{t.dtype} on {t.device}")
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    plan = bottleneck_plan(x.shape[0], _sm_count(x.device))
    fn = _build.function("bottleneck", "apex_bottleneck", _ARGS)
    err = fn(*(ctypes.c_void_p(t.data_ptr())
               for t in [x] + [p[k] for k in PARAM_NAMES] + [out]),
             x.shape[0], plan.grid, plan.seg_bands, plan.smem_bytes,
             ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(err, what)
    fused_block.launches += 1
    return out


def fused_block(x, p):
    """The fused bottleneck: the kernel on CUDA, :func:`plain_block` on the
    CPU."""
    if check_device_type(x, "fused_block") == "cpu":
        return plain_block(x, p)
    return _fused_cuda(x, p)


fused_block.launches = 0


def cudnn_weights(p):
    """OIHW bf16 conv weights in ``channels_last`` for
    :func:`cudnn_block`."""
    cl = torch.channels_last
    return {"w1": p["w1"].t()[:, :, None, None].contiguous(memory_format=cl),
            "w2": p["w2"].permute(3, 2, 0, 1).contiguous(memory_format=cl),
            "w3": p["w3"].t()[:, :, None, None].contiguous(memory_format=cl)}


def cudnn_block(x, p, wts=None):
    """The library composition: NHWC ``x`` seen as a ``channels_last`` NCHW
    tensor, three bf16 ``F.conv2d`` calls with the folded batch norms and
    ReLUs between them; returns NHWC."""
    wts = cudnn_weights(p) if wts is None else wts
    xc = x.permute(0, 3, 1, 2)                  # channels_last view

    def bn(h, g, b):
        return h * g[:, None, None] + b[:, None, None]

    h = torch.relu(bn(F.conv2d(xc, wts["w1"]), p["g1"], p["b1"]))
    h = torch.relu(bn(F.conv2d(h, wts["w2"], padding=1), p["g2"], p["b2"]))
    h = bn(F.conv2d(h, wts["w3"]), p["g3"], p["b3"])
    return torch.relu(h + xc).permute(0, 2, 3, 1)


def timed(fn, x, p, k: int = 64, windows: int = 5) -> float:
    """Milliseconds per call of ``fn(x, p)``: CUDA events around ``k``
    back-to-back calls after a warm-up, median of ``windows``."""
    fn(x, p)
    torch.cuda.synchronize()
    ts = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn(x, p)
        end.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(end) / k)
    return sorted(ts)[windows // 2]


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = make_params(device="cuda")
    x = make_input(device="cuda")
    wts = cudnn_weights(p)
    y_plain = plain_block(x, p)
    y_fused = fused_block(x, p)
    y_lib = cudnn_block(x, p, wts)
    err = float((y_fused.float() - y_plain.float()).abs().max())
    err_lib = float((y_fused.float() - y_lib.float()).abs().max())
    print("max abs err fused vs plain:", err)
    print("max abs err fused vs cuDNN composition:", err_lib)
    assert err_lib < 0.15, err_lib    # the proto's bf16 parity limit
    t_lib = timed(lambda x, p: cudnn_block(x, p, wts), x, p)
    t_fused = timed(fused_block, x, p)
    t_plain = timed(plain_block, x, p, k=4)
    print(f"cuDNN composition : {t_lib:.4f} ms")
    print(f"fused kernel      : {t_fused:.4f} ms   ({t_lib / t_fused:.2f}x)")
    print(f"plain version     : {t_plain:.4f} ms")
