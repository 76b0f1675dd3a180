"""Elastic resharding for ZeRO-3: parameter AND optimizer shards to a
topology-independent form and back, under a possibly different world
(``apex_tpu/zero/elastic.py``).

The gathered form never holds padding: each leaf is all-gathered,
unpadded to its logical size and reshaped, so resharding under a new world
only re-pads with zeros and re-slices. State saved at one world therefore
resumes at another bit-exactly: the gather moves bits, padding is zeros,
and the update never reads across leaves. The gathered trees are the same
on every rank.

The JAX package snapshots its flight recorder at each reshard boundary;
those triggers wait for the monitor port (ROADMAP A14).
"""

from __future__ import annotations

from apex_tpu_torch.zero.core import ZeroSpec, gather_tree, shard_tree
from apex_tpu_torch.zero.update import Zero3State

__all__ = ["gather_zero3_params", "shard_zero3_params",
           "gather_zero3_state", "shard_zero3_state"]


def gather_zero3_params(shards, spec: ZeroSpec) -> dict:
    """The full parameter tree from the resident shards (the checkpoint
    form)."""
    return gather_tree(shards, spec)


def shard_zero3_params(params, spec: ZeroSpec) -> dict:
    """This rank's resident shards of a full tree under the CURRENT group
    (build a fresh spec for it first)."""
    return shard_tree(params, spec)


def gather_zero3_state(state: Zero3State, spec: ZeroSpec) -> Zero3State:
    """Tier-3 state with master/m/v gathered to full parameter-shaped fp32
    trees (the step passes through)."""
    return Zero3State(step=state.step,
                      master=gather_tree(state.master, spec),
                      m=gather_tree(state.m, spec),
                      v=gather_tree(state.v, spec))


def shard_zero3_state(full_state: Zero3State, spec: ZeroSpec) -> Zero3State:
    """This rank's tier-3 state from a gathered one under the current
    group; the optimizer packs it into its flat buffers at the next
    step."""
    return Zero3State(step=full_state.step.clone(),
                      master=shard_tree(full_state.master, spec),
                      m=shard_tree(full_state.m, spec),
                      v=shard_tree(full_state.v, spec))
