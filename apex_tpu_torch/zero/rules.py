"""Regex rules deciding, per parameter, shard or replicate
(``apex_tpu/zero/rules.py``).

An ordered sequence of ``(regex, decision)`` pairs is matched with
``re.search`` against the parameter's path; the FIRST match wins, and a
parameter no rule matches is an error (a silent default would hide typos
in the table). Decisions are ``"shard"`` (1/world of the flattened leaf
resident per rank) or ``"replicate"`` (a full copy per rank).

The path is the port's parameter name with its dots joined as slashes:
``block_0.attn.qkv.kernel`` is matched as ``block_0/attn/qkv/kernel``,
which is the JAX package's flax path of the same leaf (the layouts of
ROADMAP A1), so a table written for one package reads the same here.

Two structural overrides run before the table:

- non-floating leaves replicate (no gradient to reduce-scatter);
- floating leaves under ``min_shard_size`` elements replicate (biases,
  norm scales: below that, a per-leaf gather costs more than world copies).

The JAX package also runs its lint checks of the table (shadowed and dead
rules) here; the port checks the decisions only, until the lint tooling
is ported (ROADMAP A14), and accepts ``validate`` for that reason.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.utils.tree import named_tensors

SHARD = "shard"
REPLICATE = "replicate"

#: Shard every (large, floating) leaf — the ZeRO-3 default.
DEFAULT_RULES: tuple = ((".*", SHARD),)

#: Leaves under this many ELEMENTS replicate regardless of the table.
DEFAULT_MIN_SHARD_SIZE = 2 ** 11


def leaf_path_names(name: str) -> Tuple[str, ...]:
    """``"block_0.attn.qkv.kernel"`` -> its path entries."""
    return tuple(name.split("."))


def first_match(rules: Sequence[Tuple[str, str]], name: str):
    """Index of the first rule whose regex matches ``name``, or None."""
    for i, (rx, _) in enumerate(rules):
        if re.search(rx, name) is not None:
            return i
    return None


def match_zero_rules(rules: Optional[Sequence[Tuple[str, str]]], params, *,
                     min_shard_size: int = DEFAULT_MIN_SHARD_SIZE,
                     validate=True) -> Dict[str, bool]:
    """``{name: shard this leaf?}`` for an ordered ``name -> tensor``
    mapping (or a module's named parameters). ``rules=None`` means
    :data:`DEFAULT_RULES`."""
    del validate   # the lint table checks wait for the lint port (A14)
    rules = DEFAULT_RULES if rules is None else tuple(rules)
    for rx, decision in rules:
        if decision not in (SHARD, REPLICATE):
            raise ValueError(
                f"zero rule ({rx!r}, {decision!r}): decision must be "
                f"{SHARD!r} or {REPLICATE!r}")
    out = {}
    for name, leaf in named_tensors(params).items():
        if not (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()):
            out[name] = False
            continue
        if (int(leaf.numel()) if leaf.dim() else 1) < min_shard_size:
            out[name] = False
            continue
        path = "/".join(leaf_path_names(name))
        idx = first_match(rules, path)
        if idx is None:
            raise ValueError(
                f"no zero sharding rule matched param {path!r} — add a "
                f"rule (a catch-all ('.*', 'shard') is the ZeRO-3 default)")
        out[name] = rules[idx][1] == SHARD
    return out
