"""Device resolution and the dtype map shared by the port's entry points.

``resolve_device`` is the one place that turns a caller's ``device=``
argument into a ``torch.device``: ``None`` means CUDA, and asking for CUDA
on a machine without it raises instead of quietly running on the CPU.

``as_torch_dtype`` accepts a ``torch.dtype`` or anything numpy can name
(``"bfloat16"``, ``np.float32``, the ``ml_dtypes``/JAX bfloat16 and fp8
scalar types), so configurations written for the JAX package carry over.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]

_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "apex_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def as_torch_dtype(dtype: Any) -> torch.dtype:
    """Map a torch dtype, a numpy/ml_dtypes dtype or a dtype name to torch."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"no torch dtype for {dtype!r}") from None


def check_device_type(t: torch.Tensor, what: str) -> str:
    """The dispatch rule of every kernel wrapper: ``"cuda"`` launches the
    kernel, ``"cpu"`` takes the plain version, anything else raises."""
    kind = t.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{what}: tensors on {t.device} are not supported "
                         f"(the kernel runs on CUDA, the plain version on "
                         f"the CPU)")
    return kind

