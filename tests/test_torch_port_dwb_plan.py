"""The pure-Python plans of two of the training backward's kernels (CPU
only, no device): `dwconv_gelu_bwd_plan`, how the persistent grid of
csrc/dwconv_gelu_bwd.cu covers its units and in what order the kernel
adds their partial sums, and `colsum_slice_rows`, how csrc/gemm_bwd.cu's
one-launch column sum cuts the rows."""

import pytest
import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv

# (images, hw, channels, dtype of c and h): the K2 layer (hw 16), S2's
# bf16res, K5's 512 px grid (hw 32), a ragged band (hw 20) and the widest
# float32 grid a band of one row holds
SHAPES = [(3, 16, 96, torch.float32), (2, 20, 64, torch.float32), (2, 32, 256, torch.float32),
          (3, 16, 64, torch.bfloat16), (2, 21, 32, torch.bfloat16), (1, 118, 32, torch.float32)]
GRIDS = (1, 7, 132)


def _ids(shape):
    b, hw, c, dt = shape
    return f"{b}x{hw}x{c}-{str(dt).split('.')[-1]}"


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
@pytest.mark.parametrize("grid", GRIDS)
def test_every_unit_is_walked_once(shape, grid):
    """Over all blocks of a grid of any size, the walks take every (image,
    band, chunk) once."""
    plan = lv.dwconv_gelu_bwd_plan(*shape)
    seen = [plan.unit(u) for p in range(grid) for u in plan.walk(p, grid)]
    assert len(seen) == plan.units == len(set(seen))
    assert set(seen) == {(b, band, k) for b in range(plan.images) for band in range(plan.bands)
                         for k in range(plan.chunks)}


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_walk_covers_a_partial_last_wave(shape):
    """A grid that does not divide the units leaves a partial last wave:
    the blocks' walks differ in length by at most one unit, and together
    they take every unit once."""
    plan = lv.dwconv_gelu_bwd_plan(*shape)
    grid = plan.units - 1 if plan.units > 2 else 1
    lengths = {len(plan.walk(p, grid)) for p in range(grid)}
    assert max(lengths) - min(lengths) <= 1
    assert sorted(u for p in range(grid) for u in plan.walk(p, grid)) == list(range(plan.units))


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_bands_tile_the_grid(shape):
    """The bands cover the grid's rows once: `band` rows each, the last one
    ragged where band does not divide hw; the whole grid is one band where
    it fits."""
    plan = lv.dwconv_gelu_bwd_plan(*shape)
    body = lv.dwconv_gelu_bwd_body(plan.hw, shape[3])
    assert plan.band == (body or plan.hw)
    rows = [min(plan.band, plan.hw - k * plan.band) for k in range(plan.bands)]
    assert sum(rows) == plan.hw and min(rows) > 0
    assert lv.dwconv_gelu_bwd_smem(plan.band, plan.hw, shape[3].itemsize) <= lv.fs.SMEM_PER_BLOCK


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_partial_sums_are_added_image_major(shape):
    """A chunk's partial rows are numbered image-major (bands in order
    within an image), and the last unit adds them in row order in two runs
    that together take every row once, the first run first."""
    plan = lv.dwconv_gelu_bwd_plan(*shape)
    for chunk in range(plan.chunks):
        units = [u for u in range(plan.units) if plan.unit(u)[2] == chunk]
        by_row = sorted(units, key=lambda u: u // plan.chunks)
        assert [plan.unit(u)[:2] for u in by_row] == [
            (b, band) for b in range(plan.images) for band in range(plan.bands)]
    first, second = plan.sum_runs()
    assert list(first) + list(second) == list(range(plan.rows))
    assert len(first) - len(second) in (0, 1)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plan_is_the_same_for_any_grid(shape):
    """The units, the rows they write and the summation order are the
    plan's, not the grid's: every grid size sends each unit to the same
    partial row, so the sums do not depend on how many SMs ran them."""
    plan = lv.dwconv_gelu_bwd_plan(*shape)
    rows = {}
    for grid in GRIDS + (plan.units, plan.units + 5):
        got = {u: u // plan.chunks for p in range(grid) for u in plan.walk(p, grid)}
        rows.setdefault("first", got)
        assert got == rows["first"]
    assert lv.dwconv_gelu_bwd_plan(*shape) == plan


def test_plan_rejects_a_ragged_chunk():
    with pytest.raises(ValueError, match="C % 32"):
        lv.dwconv_gelu_bwd_plan(2, 16, 48)


@pytest.mark.parametrize("r,c", [(1, 768), (31, 100), (1025, 1536), (32768, 768),
                                 (65536, 768), (1024, 2048)])
def test_colsum_slices_cover_the_rows(r, c):
    """`colsum` cuts R rows into slices of a multiple of 8 rows (the
    kernel's row lanes), at least 64 where R allows, the last one ragged,
    so that a call runs about COLSUM_BLOCKS blocks (the slices times the
    128-column tiles): db2 at batch 128 (32768 x 768) runs 384 blocks, one
    wave on an H100, and no call needs a second launch."""
    rows = lv.colsum_slice_rows(r, c)
    slices = -(-r // rows)
    tiles = -(-c // lv.COLSUM_COLS)
    assert rows % 8 == 0 and (rows >= 64 or slices == 1)
    assert (slices - 1) * rows < r <= slices * rows
    assert slices * tiles <= max(lv.COLSUM_BLOCKS, tiles) and slices < 65535
    if (r, c) == (32768, 768):
        assert slices * tiles == 384
