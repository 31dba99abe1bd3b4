"""The brick_flat kernel's tiling (csrc/brick_flat.cu), walked in plain
PyTorch by ``la.brick_flat.brick_flat_walk`` on the CPU: blocks of rows
x lanes of one plane, the box of x with zeros outside the grid, a
thread a point (those past the tile's end on its last point, not
stored), each point's sum over the terms in plan order from -0.0 with
the product and the sum rounded apart, against the plain
version (``brick_flat_apply_plain``, which tests/test_torch_bramg.py
holds to tpufem's ``flat_apply``), bit for bit.  Levels: m = 1 and m =
6, float32 and float64, on grids whose brick_flat_tiling has the
tiling's edges (a run of rows that ends inside the grid, strips of
lanes, more threads than points, a whole plane a tile).  And what
prepare_brick_flat refuses before it packs a launch."""

import dataclasses

import numpy as np
import pytest
import torch

from tpufem_torch.la import brick_flat as bf
from tpufem_torch.la.bramg import stencil_to_flat_fields

torch.set_num_threads(1)


def _level(gdims, m, dtype, seed):
    rng = np.random.default_rng(seed)
    plan, fields = stencil_to_flat_fields(
        rng.standard_normal((3, 3, 3) + gdims + (m, m)), m)
    F = torch.from_numpy(np.stack(fields)).to(dtype)
    x = torch.from_numpy(rng.standard_normal(F[0].numel())).to(dtype)
    return x, F, plan


def _last_strip(t, gdims, m):
    """The points of a row's last lane tile."""
    return gdims[2] * m - (t.xtiles - 1) * t.lanes


# (grid, m, dtype, what brick_flat_tiling's tiling of the grid must show)
CASES = {
    "m1-default-float64": ((3, 5, 4), 1, torch.float64,
                           lambda t, g, m: t.rows == 1),
    "m6-default-float32": ((2, 3, 5), 6, torch.float32,
                           lambda t, g, m: t.rows == 1),
    "m6-W6-narrower-than-halo": ((2, 3, 1), 6, torch.float64,
                                 lambda t, g, m: t.lanes < 2 * t.reach),
    "m6-az1": ((1, 4, 5), 6, torch.float32, lambda t, g, m: True),
    "m1-ay1": ((3, 1, 5), 1, torch.float32, lambda t, g, m: True),
    "m6-W150-two-lane-tiles": ((2, 2, 25), 6, torch.float32,
                               lambda t, g, m: t.xtiles == 2),
    "m1-rows-end-inside-grid": ((132, 5, 4), 1, torch.float32,
                                lambda t, g, m: t.rows > 1
                                and g[1] % t.rows),
    "m1-rows-more-threads": ((53, 9, 6), 1, torch.float64,
                             lambda t, g, m: t.rows > 1
                             and t.threads > t.rows * t.lanes),
    "m6-lane-strips": ((2, 3, 22), 6, torch.float32,
                       lambda t, g, m: t.xtiles > 1
                       and (g[2] * m) % t.lanes),
    "m6-lane-strips-more-threads": ((2, 2, 27), 6, torch.float32,
                                    lambda t, g, m: t.xtiles > 1
                                    and t.threads > _last_strip(t, g, m)),
    "m6-whole-plane": ((264, 4, 2), 6, torch.float64,
                       lambda t, g, m: (t.rows, t.lanes) == (g[1], g[2] * m)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_brick_flat_walk_gives_the_plain_versions_bits(name):
    gdims, m, dtype, shows = CASES[name]
    x, F, plan = _level(gdims, m, dtype, seed=len(name))
    t = bf.brick_flat_tiling(gdims, m)
    assert shows(t, gdims, m)
    y, counts = bf.brick_flat_walk(x, F, plan, gdims, m)
    assert torch.equal(y, bf.brick_flat_apply_plain(x, F, plan, gdims, m))
    assert counts == dict(blocks=t.blocks, twice=0)


@pytest.mark.parametrize("entry,error", [
    ((0, 0, 12), ValueError), ((2, 0, 0), ValueError),
    ((0, -2, 0), ValueError), (None, RuntimeError)],
    ids=["s_beyond_reach", "dz_beyond_box", "dy_beyond_box", "cpu_fields"])
def test_prepare_brick_flat_refusals(entry, error):
    """prepare_brick_flat refuses, before it builds or packs anything, a
    plan with a shift outside the box the kernel stages (|s| > 2m - 1,
    |dz| or |dy| > 1), which would read past the box, and fields that
    are not on the card."""
    x, F, plan = _level((2, 2, 2), 6, torch.float32, seed=5)
    if entry is not None:
        plan = list(plan)
        plan[len(plan) // 2] = entry
    with pytest.raises(error):
        bf.prepare_brick_flat(F, plan, (2, 2, 2), 6)


@pytest.mark.parametrize("gdims,m,blocks", [
    ((21, 21, 21), 1, 441), ((33, 27, 22), 1, 297), ((22, 17, 17), 6, 374)],
    ids=["poisson_amg_l1", "poisson_500k_l1", "elasticity_500k_l1"])
def test_brick_flat_tiling_fills_the_card_on_the_path_levels(gdims, m,
                                                             blocks):
    """The level-1 grids of tpufem's three brick-AMG rows: at least two
    blocks an SM of an H100 (132 SMs), whole rows a tile, a thread a
    point."""
    t = bf.brick_flat_tiling(gdims, m)
    assert t.blocks == blocks >= 2 * 132
    assert t.lanes == gdims[2] * m and t.threads >= t.rows * t.lanes
    assert t.threads % 32 == 0 and t.threads <= 256


def test_brick_flat_tiling_wide_rows_are_strips():
    """A row wider than MAX_LANES is cut into strips of single rows."""
    t = bf.brick_flat_tiling((4, 5, 30), 6)
    assert (t.rows, t.lanes, t.xtiles) == (1, bf.MAX_LANES, 2)
    assert dataclasses.replace(t, blocks=0).blocks == 0  # frozen, replaceable
