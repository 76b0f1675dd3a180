"""Opt-level properties (``apex_tpu/amp/properties.py``).

A ``Properties`` bag and the O0/O2/O3 tables, overridable by explicit
keyword arguments of :func:`~apex_tpu_torch.amp.initialize`. The half type
defaults to bfloat16; an O2 or O3 model in bfloat16 gets a static loss
scale of 1.0 and in float16 a dynamic one, as in the JAX package.

O1 (the per-op autocast policy) and O4 (fp8 with delayed scaling) are not
ported yet: asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch


class Properties:
    """Mutable options bag: an opt level stamps its defaults, explicit
    overrides win."""

    def __init__(self):
        self.options = {
            "enabled": False,
            "opt_level": None,
            "cast_model_type": None,       # dtype params are cast to (O2/O3)
            "cast_ops": False,             # O1 per-op autocast (not ported)
            "cast_model_outputs": None,    # force outputs to this dtype
            "keep_batchnorm_fp32": None,   # exempt batchnorm params
            "master_weights": None,        # fp32 master params in optimizer
            "loss_scale": 1.0,             # float or "dynamic"
            "half_dtype": torch.bfloat16,  # what "half" means
        }

    def __getattr__(self, name):
        if "options" in self.__dict__ and name in self.__dict__["options"]:
            return self.options[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if "options" in self.__dict__ and name in self.options:
            if (name == "loss_scale" and value != "dynamic"
                    and value is not None):
                value = float(value)
            if name == "keep_batchnorm_fp32" and isinstance(value, str):
                if value not in ("True", "False"):
                    raise ValueError("keep_batchnorm_fp32 string must be "
                                     f"'True'/'False', got {value}")
                value = value == "True"
            self.options[name] = value
        else:
            super().__setattr__(name, value)


def _half_loss_scale(properties: Properties):
    return "dynamic" if properties.half_dtype == torch.float16 else 1.0


class O3:
    brief = "O3: Pure half precision (speed-of-light baseline)."

    def __call__(self, properties: Properties) -> Properties:
        properties.enabled = True
        properties.opt_level = "O3"
        properties.cast_model_type = properties.half_dtype
        properties.cast_ops = False
        properties.keep_batchnorm_fp32 = False
        properties.master_weights = False
        properties.loss_scale = 1.0
        return properties


class O2:
    brief = ("O2: 'Almost half' — half model, fp32 batchnorm and master "
             "weights.")

    def __call__(self, properties: Properties) -> Properties:
        properties.enabled = True
        properties.opt_level = "O2"
        properties.cast_model_type = properties.half_dtype
        properties.cast_ops = False
        properties.keep_batchnorm_fp32 = True
        properties.master_weights = True
        properties.loss_scale = _half_loss_scale(properties)
        return properties


class O0:
    brief = "O0: Pure fp32 (accuracy baseline)."

    def __call__(self, properties: Properties) -> Properties:
        properties.enabled = True
        properties.opt_level = "O0"
        properties.cast_model_type = torch.float32
        properties.cast_ops = False
        properties.keep_batchnorm_fp32 = None
        properties.master_weights = False
        properties.loss_scale = 1.0
        return properties


class _NotPorted:
    def __init__(self, level: str, what: str):
        self.level, self.what = level, what
        self.brief = f"{level}: not ported yet"

    def __call__(self, properties: Properties) -> Properties:
        raise NotImplementedError(
            f"opt_level {self.level} ({self.what}) is not ported to "
            "apex_tpu_torch yet; use O0, O2 or O3")


opt_levels = {"O4": _NotPorted("O4", "fp8 delayed scaling"), "O3": O3(),
              "O2": O2(),
              "O1": _NotPorted("O1", "the per-op autocast policy"),
              "O0": O0()}
