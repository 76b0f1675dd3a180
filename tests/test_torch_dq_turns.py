"""The single-pass flash backward's dq order (``csrc/turns.cuh``).

The kernels add each query tile's dq partials in a fixed order of key
blocks, so dq is the same bits on every run. These CPU tests hold the
order's plan (``single_pass_dq_order``) to the properties the kernels rely
on, at the shapes ``chip_smoke.py`` runs and at ragged and dead-tile ones:

- the key blocks that reach a tile are blocks 0 .. J, so the kernels' turn
  numbers (J - j, with J from the tile's last row and the route's key
  block) are the positions in the order, each taken once;
- every block waits only for a block of a smaller linear index in its grid
  (dispatched before it), so no waiting block holds back the one it waits
  for;
- the workspace holds a zeroed counter for every (tile, column chunk).
"""

import pytest
import torch

from apex_tpu_torch.ops import flash_attention as fa

ROWS = 64


def _reach(sq, sk, causal, keys):
    """Brute force: the key blocks a query tile's rows see a key of."""
    n_qt, n_kb = -(-sq // ROWS), -(-sk // keys)
    off = sk - sq
    out = []
    for qt in range(n_qt):
        rows = range(qt * ROWS, min(sq, qt * ROWS + ROWS))
        out.append([j for j in range(n_kb)
                    if any(not causal or j * keys <= r + off for r in rows)])
    return out


SHAPES = [
    (1024, 1024, True),      # the train cells' single pass (b8 h16)
    (1024, 1024, False),
    (300, 300, True),        # ragged
    (100, 300, True),        # sq < sk: the offset reaches keys early
    (300, 100, True),        # sq > sk: the first tiles see no key at all
    (2304, 2304, True),
    (65, 700, False),
]


@pytest.mark.parametrize("sm90", [True, False])
@pytest.mark.parametrize("sq,sk,causal", SHAPES)
def test_order_covers_the_reaching_blocks_once(sq, sk, causal, sm90):
    keys = 128 if sm90 else 64
    order = fa.single_pass_dq_order(sq, sk, causal, sm90)
    reach = _reach(sq, sk, causal, keys)
    assert len(order) == -(-sq // ROWS)
    for qt, (o, r) in enumerate(zip(order, reach)):
        assert sorted(o) == r, qt      # the blocks whose keys it sees
        assert o == list(range(len(o)))[::-1], qt     # J .. 0


@pytest.mark.parametrize("sm90", [True, False])
@pytest.mark.parametrize("sq,sk,causal", SHAPES)
def test_kernel_turn_numbers_match_the_order(sq, sk, causal, sm90):
    """The turn the kernels compute for key block j on tile qt is its place
    in the order: J - j, with J = min(n_kb - 1, (64 qt + 63 + sk - sq) //
    keys) under a causal mask (keys: 128 a block on the wgmma route, 64 on
    flash_bwd.cu's), else n_kb - 1."""
    keys = 128 if sm90 else 64
    order = fa.single_pass_dq_order(sq, sk, causal, sm90)
    n_kb = -(-sk // keys)
    for qt, o in enumerate(order):
        last = (min(n_kb - 1, (64 * qt + 63 + sk - sq) // keys)
                if causal else n_kb - 1)
        for pos, j in enumerate(o):
            assert pos == last - j


@pytest.mark.parametrize("sm90", [True, False])
@pytest.mark.parametrize("sq,sk,causal", SHAPES)
def test_each_block_waits_only_for_an_earlier_dispatched_block(sq, sk,
                                                               causal, sm90):
    bh = 3
    n_kb = -(-sk // (128 if sm90 else 64))

    def linear(j, head=1):
        # wgmma route: grid (b h, key block in reverse); flash_bwd.cu: grid
        # (key tile in reverse, h, b * chunk)
        return (head + bh * (n_kb - 1 - j) if sm90
                else (n_kb - 1 - j) + n_kb * head)

    for o in fa.single_pass_dq_order(sq, sk, causal, sm90):
        for prev, cur in zip(o, o[1:]):
            assert linear(prev) < linear(cur)


@pytest.mark.parametrize("kd", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("sm90", [True, False])
def test_workspace_holds_zeroed_dq_and_a_counter_a_tile(kd, sm90):
    b, h, sq = 2, 3, 130
    q = torch.empty(b, h, sq, kd)
    dq_acc, turns = fa._dq_workspace(q, kd, sm90)
    n_qt = -(-sq // ROWS)
    assert dq_acc.shape == q.shape and dq_acc.dtype == torch.float32
    assert turns.dtype == torch.int32
    # flash_bwd.cu: a counter a (batch x column chunk, head, tile), at most
    # kd / 32 chunks (the gradient columns a block are at least 32 wide)
    want = b * h * n_qt * (1 if sm90 else kd // 32)
    assert turns.numel() == fa.single_pass_turns(b, h, sq, kd, sm90) == want
    assert not dq_acc.any() and not turns.any()
    assert dq_acc.data_ptr() % 16 == 0                 # the TMA map's base
    assert turns.data_ptr() >= dq_acc.data_ptr() + dq_acc.numel() * 4
