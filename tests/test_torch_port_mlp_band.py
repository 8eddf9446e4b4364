"""K5's band kernels (csrc/mlp_band_fwd.cu, csrc/mlp_band_bwd.cu) without a
card: their tiling, emulated in plain PyTorch, against the plain versions
and the JAX package's K5, and the route's launches.

- The emulation follows `fused_mlp_vjp.BandPlan` as the kernels do: each
  image cut into tiles of 128 consecutive tokens (one cluster of blocks),
  each tile's float32 h (and in the backward da, then dc) staged on its
  own, a 3x3 tap read from the own tile or a neighbouring one only (a
  tile further away raises), zeros outside the grid, each tile's pixels
  walked in runs of at most 8 pixels of a grid row dealt to 8 warps, and
  the backward's 11 sums added in the kernel's fixed order (each warp's
  pixels in walk order, the warps in order, the cluster's tiles in rank
  order, the images in order). It is held against
  `fused_mlp_sepconv_plain` / `fused_mlp_sepconv_bwd_plain` at hw in {4,
  11, 12, 16, 17, 24, 31, 32} (batch 2, d 64, hidden 256, float32), and
  against the JAX K5 (`fused_mlp_sepconv_vjp`'s forward and `_pallas_bwd`
  in interpret mode) at hw in {4, 17, 32}: every output within atol 1e-4 /
  rtol 1e-3, the bounds of tests/test_torch_port_highres_train.py's
  `test_fused_mlp_sepconv_bwd_plain_matches_jax_kernel` (summation order
  and the TPU kernel's erf polynomial).
- The launch table: on a stand-in card (meta tensors, a library that
  records its entry points) a bf16 forward launches `mlp_band_fwd` and
  `ln_gemm` once each, a backward `mlp_band_bwd`, `weight_grad` twice,
  `colsum` (reading g as it is, bf16) and `ln_gemm`: `ROUTE_LAUNCHES`.
The kernels themselves are held against the plain versions on the card in
tests/test_torch_port_cuda.py and chip_smoke.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.ops.fused_mlp_vjp import _pallas_bwd
from transformer_latent_diffusion_tpu.ops.fused_mlp_vjp import (
    fused_mlp_sepconv_vjp as jax_fused_mlp,
)
from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
from transformer_latent_diffusion_tpu_torch.ops import fused_mlp_vjp as fm
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

torch.set_num_threads(2)

ATOL, RTOL = 1e-4, 1e-3
OUTPUTS = ("dx", "dw1", "db1", "ddw", "ddwb", "dw2", "db2")


def _inputs(hw, d=64, hidden=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, hw * hw, d)).astype(np.float32),
            (rng.standard_normal((d, hidden)) * d ** -0.5).astype(np.float32),
            (rng.standard_normal(hidden) * 0.1).astype(np.float32),
            (rng.standard_normal((9, hidden)) / 3).astype(np.float32),
            (rng.standard_normal(hidden) * 0.1).astype(np.float32),
            (rng.standard_normal((hidden, d)) * hidden ** -0.5).astype(np.float32),
            (rng.standard_normal(d) * 0.1).astype(np.float32))


def _port(x, w1, b1, dw, dwb, w2, b2):
    """The JAX layouts in the port's, float32: (out, in) products."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return t(x), t(w1.T), t(b1), t(dw), t(dwb), t(w2.T), t(b2)


# ------------------------------ the tiling, emulated ------------------------------


def _tiles(plan, rows):
    """(B, n, C) float32 -> one (B, 128, C) staged tile a rank, a ragged last
    tile padded with zeros (the kernels never read past the grid)."""
    out = []
    for r in range(plan.tiles):
        t = rows[:, plan.tokens(r)]
        out.append(torch.nn.functional.pad(t, (0, 0, 0, fm.BAND_TILE - t.shape[1])))
    return out


def _walk(plan, rank):
    """Tile `rank`'s pixels as the kernels walk them: per warp, its runs'
    pixels in order; every own token exactly once."""
    per_warp = [[] for _ in range(fm.BAND_WARPS)]
    for item, i, j0, j1 in plan.runs(rank):
        per_warp[item % fm.BAND_WARPS] += [(i, j) for j in range(j0, j1)]
    walked = sorted(i * plan.hw + j for pix in per_warp for i, j in pix)
    assert walked == list(plan.tokens(rank))
    return per_warp


def _neighbourhood(plan, staged, rank, pixels):
    """(B, P, 3, 3, C): the staged value at (i + di - 1, j + dj - 1) of each
    pixel, read from the tiles of ranks rank - 1 .. rank + 1 only (the
    cluster's neighbours), zero outside the hw x hw grid."""
    b, tile, c = staged[rank].shape
    zero = torch.zeros(b, tile, c)
    window = torch.cat([staged[r] if 0 <= r < plan.tiles else zero
                        for r in (rank - 1, rank, rank + 1)] + [zero[:, :1]], 1)
    idx, hw = [], plan.hw
    for i, j in pixels:
        for di in range(3):
            for dj in range(3):
                ii, jj = i + di - 1, j + dj - 1
                if not (0 <= ii < hw and 0 <= jj < hw):
                    idx.append(3 * tile)  # the zero row
                    continue
                src, off = divmod(ii * hw + jj, tile)
                assert abs(src - rank) <= 1, "a tap beyond the neighbouring tiles"
                idx.append((src - rank + 1) * tile + off)
    return window[:, idx].reshape(b, len(pixels), 3, 3, c)


def _conv(nb, w, bias=None):
    """The TPU kernel's order: row taps per column shift, then the shifts."""
    w = w.reshape(3, 3, -1)
    z = [nb[:, :, 0, dj] * w[0, dj] + nb[:, :, 1, dj] * w[1, dj] + nb[:, :, 2, dj] * w[2, dj]
         for dj in range(3)]
    out = z[0] + z[1] + z[2]
    return out if bias is None else out + bias


def _gelu(c):
    return 0.5 * c * (1.0 + torch.erf(c * (1.0 / math.sqrt(2.0))))


def _gelu_grad(c):
    cdf = 0.5 * (1.0 + torch.erf(c * (1.0 / math.sqrt(2.0))))
    return cdf + c * torch.exp(-0.5 * c * c) / math.sqrt(2.0 * math.pi)


def _scatter(plan, per_rank, b, c):
    """Each rank's values of its walked pixels back into token order."""
    out = torch.zeros(b, plan.hw * plan.hw, c)
    for r, (pixels, v) in enumerate(per_rank):
        out[:, [i * plan.hw + j for i, j in pixels]] = v
    return out


def _emulate_fwd(x, w1, b1, dw, dwb, hw):
    """mlp_band_fwd as the kernel tiles it; x (B, n, D) float32 -> a."""
    b, n, d = x.shape
    plan = fm.band_plan(b, hw, w1.shape[0])
    h = fs.ln_gemm_plain(x.reshape(b * n, d), w1, bias=b1,
                         out_dtype=torch.float32).reshape(b, n, -1)
    staged, per_rank = _tiles(plan, h), []
    for r in range(plan.tiles):
        pixels = [p for warp in _walk(plan, r) for p in warp]
        c = _conv(_neighbourhood(plan, staged, r, pixels), dw.float(), dwb)
        per_rank.append((pixels, _gelu(c).to(dw.dtype).float()))
    return _scatter(plan, per_rank, b, plan.channels).reshape(b * n, -1).to(dw.dtype)


def _emulate_bwd(x, g, w1, b1, dw, dwb, w2, hw):
    """mlp_band_bwd as the kernel tiles it and sums: (a, dh, ddw, ddwb, db1)."""
    b, n, d = x.shape
    plan = fm.band_plan(b, hw, w1.shape[0])
    cc = plan.channels
    x2, g2 = x.reshape(b * n, d), g.reshape(b * n, d)
    h = fs.ln_gemm_plain(x2, w1, bias=b1, out_dtype=torch.float32).reshape(b, n, cc)
    da = fs.ln_gemm_plain(g2, w2, out_dtype=torch.float32, w_transposed=True).reshape(b, n, cc)
    h_tiles, da_tiles = _tiles(plan, h), _tiles(plan, da)
    walks = [_walk(plan, r) for r in range(plan.tiles)]
    # walk 1: c over the h halo, a out, da -> dc in place
    a_ranks, dc_tiles = [], []
    for r, warps in enumerate(walks):
        pixels = [p for warp in warps for p in warp]
        c = _conv(_neighbourhood(plan, h_tiles, r, pixels), dw.float(), dwb)
        a_ranks.append((pixels, _gelu(c).to(dw.dtype).float()))
        dc = da_tiles[r].clone()
        own = [i * hw + j - r * fm.BAND_TILE for i, j in pixels]
        dc[:, own] = dc[:, own] * _gelu_grad(c)
        dc_tiles.append(dc)
    # walk 2: dh over the dc halo; the 11 sums in the kernel's order
    dh_ranks, rows = [], None
    flipped = dw.float().flip(0)
    for r, warps in enumerate(walks):
        part = None
        for w_pixels in warps:
            if not w_pixels:
                part_w = torch.zeros(b, fm.BAND_NSUM, cc)
            else:
                nb_dc = _neighbourhood(plan, dc_tiles, r, w_pixels)
                nb_h = _neighbourhood(plan, h_tiles, r, w_pixels)
                dh = _conv(nb_dc, flipped)
                centre = nb_dc[:, :, 1, 1]
                prods = torch.cat([(nb_h * centre[:, :, None, None]).reshape(b, -1, 9, cc),
                                   centre[:, :, None], dh[:, :, None]], 2)
                part_w = torch.zeros(b, fm.BAND_NSUM, cc)
                for p in range(len(w_pixels)):  # a thread's pixels, in walk order
                    part_w = part_w + prods[:, p]
                dh_ranks.append((w_pixels, dh.to(dw.dtype).float()))
            part = part_w if part is None else part + part_w  # the warps in order
        rows = part if rows is None else rows + part  # the cluster's ranks in order
    sums = rows[0]
    for i in range(1, b):  # the images in order
        sums = sums + rows[i]
    pixels = [p for pix, _ in dh_ranks for p in pix]
    dh = _scatter(plan, [(pixels, torch.cat([v for _, v in dh_ranks], 1))], b, cc)
    a = _scatter(plan, a_ranks, b, cc)
    return (a.reshape(b * n, cc).to(dw.dtype), dh.reshape(b * n, cc).to(dw.dtype),
            sums[:9], sums[9], sums[10])


def _emulate_full_bwd(x, g, w1, b1, dw, dwb, w2, hw):
    """K5's 7 gradients with the band kernel emulated and the products
    around it plain (`fused_mlp_vjp._mlp_bwd` with the emulation)."""
    band = (lambda x2, g2, *a: _emulate_bwd(x2.reshape(x.shape), g2.reshape(x.shape), *a))
    return fm._mlp_bwd(x, g, w1, b1, dw, dwb, w2, hw,
                       (band, lv.weight_grad_plain, lv.colsum_plain, fs.ln_gemm_plain))


def _emulate_full_fwd(x, w1, b1, dw, dwb, w2, b2, hw):
    band = (lambda x2, *a: _emulate_fwd(x2.reshape(x.shape), *a))
    return fm._mlp(x, w1, b1, dw, dwb, w2, b2, hw, (band, fs.ln_gemm_plain))


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32).reshape(np.shape(got)),
                               atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("hw", [4, 11, 12, 16, 17, 24, 31, 32])
def test_band_tiling_matches_plain(hw):
    """The emulated tiling against the plain versions: the forward's y and
    the 7 gradients, float32, within atol 1e-4 / rtol 1e-3."""
    args = _port(*_inputs(hw, seed=hw))
    x, w1, b1, dw, dwb, w2, b2 = args
    g = torch.from_numpy(np.random.default_rng(hw + 1).standard_normal(x.shape)
                         .astype(np.float32))
    _close(_emulate_full_fwd(*args, hw), fm.fused_mlp_sepconv_plain(*args, hw), "y")
    got = _emulate_full_bwd(x, g, w1, b1, dw, dwb, w2, hw)
    want = fm.fused_mlp_sepconv_bwd_plain(x, g, w1, b1, dw, dwb, w2, hw)
    for name, u, w in zip(OUTPUTS, got, want):
        _close(u, w, name)


@pytest.mark.parametrize("hw", [4, 17, 32])
def test_band_tiling_matches_jax_kernel(hw):
    """The emulated tiling against the JAX K5 in interpret mode (its
    forward, and `_pallas_bwd`'s 7 outputs, JAX's (in, out) weight
    gradients transposed), float32, within atol 1e-4 / rtol 1e-3."""
    arrays = _inputs(hw, seed=hw)
    x, w1, b1, dw, dwb, w2, b2 = arrays
    g = np.random.default_rng(hw + 1).standard_normal(x.shape).astype(np.float32)
    args = _port(*arrays)
    want_y = jax_fused_mlp(*(jnp.asarray(a) for a in arrays), hw, True)
    _close(_emulate_full_fwd(*args, hw), want_y, "y")
    want = _pallas_bwd(*(jnp.asarray(a) for a in (x, g, w1, b1, dw, dwb, w2)), hw, True)
    px, pw1, pb1, pdw, pdwb, pw2, _ = args
    got = [t.numpy() for t in _emulate_full_bwd(px, torch.from_numpy(g), pw1, pb1, pdw, pdwb,
                                                pw2, hw)]
    got[1], got[5] = got[1].T, got[5].T
    for name, u, w in zip(OUTPUTS, got, want):
        _close(u, w, name)


@pytest.mark.parametrize("hw,tiles,ok", [(1, 1, True), (11, 1, True), (12, 2, True),
                                         (17, 3, True), (32, 8, True), (33, 9, False)])
def test_band_plan_clusters(hw, tiles, ok):
    """A cluster holds an image's ceil(hw^2 / 128) tiles, at most 8 (hw <=
    32, the grids the route sends: N <= 1024); a tap's halo (hw + 1 tokens)
    never reaches past the neighbouring tiles, and the walk covers every
    token of a tile once."""
    if not ok:
        with pytest.raises(ValueError, match="hw <= 32"):
            fm.band_plan(2, hw, 256)
        return
    plan = fm.band_plan(2, hw, 256)
    assert plan.tiles == tiles and plan.chunks == 2
    assert hw + 1 <= fm.BAND_TILE
    for r in range(plan.tiles):
        _walk(plan, r)
    with pytest.raises(ValueError, match="hidden % 128"):
        fm.band_plan(2, hw, 192)


# ------------------------------ the route's launches ------------------------------


class _RecordingLib:
    """The kernels' library: records each entry point called, launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name == "ltd_ln_gemm_scratch_rows":  # a size query, no launch
            return lambda *a: 0

        def call(*args):
            self.calls.append((name, args))
            return 0
        return call

    def names(self):
        return [name for name, _ in self.calls]


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors pass for CUDA ones: the wrappers' checks, allocation and
    dispatch run, the library records the entry points."""
    lib = _RecordingLib()
    meta = torch.device("meta")
    monkeypatch.setattr(fm, "_require_cuda", lambda name, x: None)
    for mod in (fs, lv):
        monkeypatch.setattr(mod, "_on_cuda", lambda name, *ts: meta)
        monkeypatch.setattr(mod, "_stream", lambda dev: None)
        monkeypatch.setattr(mod, "_ptr", lambda t: None)
        monkeypatch.setattr(mod, "load_library", lambda: lib)
    monkeypatch.setattr(lv, "_zeroed_counters",
                        lambda dev, n: torch.zeros(n, dtype=torch.int32, device=meta))
    monkeypatch.setattr(lv, "_plan_on", lambda m, n, k, dev: (
        lv.weight_grad_plan(m, n, k, 132), torch.zeros(1, dtype=torch.int32, device=meta)))
    for mod in (fm, fs, lv):
        mod.reset_launch_counts()
    yield lib
    for mod in (fm, fs, lv):
        mod.reset_launch_counts()


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _launches():
    counts = {**fs.LAUNCHES, **lv.LAUNCHES, **fm.LAUNCHES}
    return {k: v for k, v in counts.items() if v}


@pytest.mark.parametrize("hw", [17, 32])
def test_route_launches_match_the_table(fake_card, hw):
    """bf16 K5 at hw = 17 and 32, d 128: the forward makes `mlp_band_fwd`
    then `ln_gemm`, the backward `mlp_band_bwd`, `weight_grad` (dW2),
    `colsum` (db2, g read as bf16), `weight_grad` (dW1), `ln_gemm` (dx):
    ROUTE_LAUNCHES, plus each route's one call."""
    d, c, f = 128, 512, torch.float32
    x, g = _meta(2, hw * hw, d), _meta(2, hw * hw, d)
    w1, dw, w2 = _meta(c, d), _meta(9, c), _meta(d, c)
    b1, dwb, b2 = _meta(c, dtype=f), _meta(c, dtype=f), _meta(d, dtype=f)
    with torch.no_grad():
        y = fm.fused_mlp_sepconv(x, w1, b1, dw, dwb, w2, b2, hw)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert fake_card.names() == ["ltd_mlp_band_fwd", "ltd_ln_gemm"]
    # (.., B, hw, D, C, stream) after the six pointers
    assert fake_card.calls[0][1][6:10] == (2, hw, d, c)
    assert _launches() == {**fm.ROUTE_LAUNCHES["fused_mlp_sepconv"], "fused_mlp_sepconv": 1}
    fake_card.calls.clear()
    for mod in (fm, fs, lv):
        mod.reset_launch_counts()
    out = fm.fused_mlp_sepconv_bwd(x, g, w1, b1, dw, dwb, w2, hw)
    assert [t.shape for t in out] == [x.shape, (c, d), (c,), (9, c), (c,), (d, c), (d,)]
    assert fake_card.names() == ["ltd_mlp_band_bwd", "ltd_weight_grad", "ltd_colsum",
                                 "ltd_weight_grad", "ltd_ln_gemm"]
    assert fake_card.calls[0][1][12:16] == (2, hw, d, c)
    # colsum reads g itself: R, C, the slice rows, then bf16 x
    assert fake_card.calls[2][1][4:6] == (2 * hw * hw, d) and fake_card.calls[2][1][7] == 1
    assert _launches() == {**fm.ROUTE_LAUNCHES["fused_mlp_sepconv_bwd"],
                           "fused_mlp_sepconv_bwd": 1}


def test_band_wrappers_refuse_what_the_kernels_do_not_take(fake_card):
    """A grid past 32 x 32, a hidden width that is no multiple of 128, or
    float32 operands raise before any launch."""
    f = torch.float32
    with pytest.raises(ValueError, match="hw <= 32"):
        fm.mlp_band_fwd(_meta(2 * 33 * 33, 64), _meta(256, 64), _meta(256, dtype=f),
                        _meta(9, 256), _meta(256, dtype=f), 33)
    with pytest.raises(ValueError, match="hw <= 32"):
        fm.mlp_band_bwd(_meta(2 * 33 * 33, 64), _meta(2 * 33 * 33, 64), _meta(256, 64),
                        _meta(256, dtype=f), _meta(9, 256), _meta(256, dtype=f),
                        _meta(64, 256), 33)
    with pytest.raises(ValueError, match="hidden % 128"):
        fm.mlp_band_fwd(_meta(2 * 16, 64), _meta(192, 64), _meta(192, dtype=f),
                        _meta(9, 192), _meta(192, dtype=f), 4)
    with pytest.raises(ValueError, match="bf16"):
        fm.mlp_band_bwd(_meta(2 * 16, 64, dtype=f), _meta(2 * 16, 64), _meta(256, 64),
                        _meta(256, dtype=f), _meta(9, 256), _meta(256, dtype=f),
                        _meta(64, 256), 4)
    assert fake_card.calls == [] and not _launches()


def test_band_phases_finds_every_boundary():
    """scripts/band_phases.py stamps each phase boundary of the two band
    kernels: every boundary it expects is still in the sources (it raises
    otherwise), once each."""
    from transformer_latent_diffusion_tpu_torch.scripts import band_phases as bp

    sources = bp.traced_sources(blocks=8)
    for name, (phases, _) in bp.EDITS.items():
        # a stamp before and after each phase, and the helper's definition
        for k in range(len(phases) + 1):
            assert sources[name].count(f"stamp({k});") == 1
        assert "stamps_get" in sources[name]
