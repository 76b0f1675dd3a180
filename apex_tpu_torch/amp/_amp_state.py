"""Process-global amp state and verbosity-gated printing
(``apex_tpu/amp/_amp_state.py``). The port runs one process per card and
prints from every rank that asks."""

from __future__ import annotations


class AmpState:
    def __init__(self):
        self.hard_override = False
        self.enabled = True
        self.verbosity = 1
        self.opt_properties = None
        self.loss_scalers: list = []


_amp_state = AmpState()


def maybe_print(msg: str, rank0: bool = False):
    del rank0
    if _amp_state.verbosity > 0:
        print(msg)


def warn_or_err(msg: str):
    if _amp_state.hard_override:
        maybe_print("Warning: " + msg)
    else:
        raise RuntimeError(msg)
