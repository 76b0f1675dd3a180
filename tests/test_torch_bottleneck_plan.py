"""The fused bottleneck's schedule (B15, ``csrc/bottleneck.cu``) as its
Python mirror ``bottleneck_plan`` states it, on the CPU: every output band
of every image computed exactly once, the h1 window each band reads holding
exactly the rows its 3x3 needs, the weights loaded once per block, at most
one block an SM, the shared-memory budget within the H100's 232,448 bytes
and the recompute ratio the kernel's header states. Integer bookkeeping
only: no tolerance applies."""

import re
from collections import Counter
from pathlib import Path

import pytest

from apex_tpu_torch.scripts import bottleneck_proto as bp

SOURCE = (Path(bp.__file__).resolve().parent.parent / "csrc" /
          "bottleneck.cu").read_text()
NS = [1, 3, 5, 32, 40]


@pytest.mark.parametrize("n", NS)
def test_every_band_of_every_image_computed_exactly_once(n):
    plan = bp.bottleneck_plan(n)
    tiles = Counter(e[1:] for b in range(plan.grid)
                    for e in bp.plan_schedule(plan, b) if e[0] == "tile")
    want = {(img, strip, band) for img in range(n)
            for strip in range(bp.STRIPS) for band in range(bp.BANDS)}
    assert set(tiles) == want
    assert set(tiles.values()) == {1}


@pytest.mark.parametrize("n", NS)
def test_h1_window_holds_the_rows_each_band_reads(n):
    """The kernel keeps the last two h1 rows and adds BAND new ones a
    phase-1 product; a band of output rows Y .. Y + 3 reads h1 rows
    Y - 1 .. Y + 4 of its own strip."""
    plan = bp.bottleneck_plan(n)
    for b in range(plan.grid):
        window, where = [], None
        for ev in bp.plan_schedule(plan, b):
            if ev[0] == "h1":
                _, img, strip, first = ev
                if (img, strip) != where:
                    window = []
                window = window[-2:] + list(range(first, first + bp.BAND))
                where = (img, strip)
            elif ev[0] == "tile":
                _, img, strip, band = ev
                y = band * bp.BAND
                assert where == (img, strip)
                assert window == list(range(y - 1, y + bp.BAND + 1))


@pytest.mark.parametrize("n", NS)
def test_weights_loaded_once_per_block(n):
    plan = bp.bottleneck_plan(n)
    for b in range(plan.grid):
        ev = bp.plan_schedule(plan, b)
        loads = [e for e in ev if e[0] == "weights"]
        assert loads == [("weights", "w1"), ("weights", "w2"),
                         ("weights", "w3")]
        assert ev[:3] == loads
        assert any(e[0] == "tile" for e in ev)


@pytest.mark.parametrize("n", NS)
def test_grid_at_most_one_block_an_sm(n):
    plan = bp.bottleneck_plan(n)
    assert 1 <= plan.grid <= min(bp.SMS, plan.units)
    assert plan.units == n * bp.STRIPS * plan.segs
    assert plan.segs == -(-bp.BANDS // plan.seg_bands)
    small = bp.bottleneck_plan(n, sms=8)
    assert small.grid <= 8


def test_shared_memory_within_the_h100_block_limit():
    assert bp.SMEM_BYTES <= bp.SMEM_LIMIT == 232_448
    assert bp.bottleneck_plan(32).smem_bytes == bp.SMEM_BYTES
    stated = re.search(r"([\d,]+) of the 232,448 a block may use", SOURCE)
    assert int(stated.group(1).replace(",", "")) == bp.SMEM_BYTES
    assert f"constexpr int STAGES = {bp.X_STAGES};" in SOURCE
    weights = sum(b for name, b in bp.SMEM_LAYOUT if name in ("w1", "w2",
                                                              "w3"))
    assert weights == 139_264


def test_recompute_ratio_is_the_one_the_header_states():
    stated = re.search(r"Recompute ratio .*? at N 32: .*?= (\d\.\d+)",
                       SOURCE, re.S)
    plan = bp.bottleneck_plan(32)
    assert plan.seg_bands == bp.BANDS and plan.grid == 128
    assert round(bp.recompute_ratio(plan), 4) == float(stated.group(1))
    # against the first port's 10 x 10 haloed 8 x 8 tiles
    assert bp.recompute_ratio(plan) < 100 / 64
