"""ln_gemm_f32's training modes (csrc/ln_gemm_f32.cu), emulated in numpy on
the CPU: the layout, the arithmetic and the schedule the card runs.

Both modes run the product on W given as its TF32 parts: a split pre-pass
(`split_w_kernel`) writes the hi and lo parts of W (N, K), or of W^T for the
dX products' W stored (K, N), as two (N, K) row-major arrays, which the
product's producer takes by TMA with the 128-byte swizzle. `return_xn`
first writes the float32 LayerNorm rows in a row pass (`ln_rows_kernel`,
one warp a row) and runs the product on them. The two consumer warpgroups
take the tensor cores in turns over a ring of four stages; each stage's 12
products go into a fresh partial, added into the tile's float32 sum.
Here: the pre-pass's index map and the swizzled stage images the consumers
read (every element once, hi + lo within 2^-22 of W^T), the row pass's sums
in the kernel's order against the plain version's rows, the products'
schedule against float64 at the layer's K (768, 1536, 2304, 3072), and the
turns over the ring as a state machine (no deadlock, each warpgroup's
flushes in stage order), and what scripts/ln_gemm_f32_ab.py builds and
binds. No card, no jax."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_port_tf32_split import (F32_KERNEL_REL_L2, MARGIN, _layer_norm, _rel,
                                              tc_product, tf32_parts)
from transformer_latent_diffusion_tpu_torch.ops import _build
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.scripts import ln_gemm_f32_ab as ab

BN, BK, STAGES = 128, 32, 4  # the product's output tile columns, K per stage, ring depth
SPLIT_TILE = 32              # the pre-pass's tiles, 32 x 8 threads


def _split_pass(w, transposed):
    """split_w_kernel on the host: every block (bx, by) and thread (tx, ty)
    as the kernel indexes them; returns hi, lo (N, K) and how many times
    each element was written."""
    n, k = (w.shape[1], w.shape[0]) if transposed else w.shape
    hi, lo = np.zeros((n, k), np.float32), np.zeros((n, k), np.float32)
    writes = np.zeros((n, k), np.int64)
    tx, ty = np.meshgrid(np.arange(SPLIT_TILE), np.arange(8), indexing="ij")
    for bx in range(-(-n // SPLIT_TILE)):
        for by in range(-(-k // SPLIT_TILE)):
            n0, k0 = bx * SPLIT_TILE, by * SPLIT_TILE
            tile = np.zeros((SPLIT_TILE, SPLIT_TILE + 1), np.float32)
            if transposed:  # tile[i][tx] = w[k0 + i][n0 + tx]
                for i0 in range(0, SPLIT_TILE, 8):
                    i = ty + i0
                    kk, nn = k0 + i, n0 + tx
                    ok = (kk < k) & (nn < n)
                    tile[i, tx] = np.where(ok, w[np.minimum(kk, k - 1), np.minimum(nn, n - 1)], 0)
            for i0 in range(0, SPLIT_TILE, 8):
                i = ty + i0
                nn, kk = n0 + i, k0 + tx
                ok = (nn < n) & (kk < k)
                src = tile[tx, i] if transposed else w[np.minimum(nn, n - 1), np.minimum(kk, k - 1)]
                h, l = tf32_parts(src)
                hi[nn[ok], kk[ok]], lo[nn[ok], kk[ok]] = h[ok], l[ok]
                np.add.at(writes, (nn[ok], kk[ok]), 1)
    return hi, lo, writes


def _stage_image(part, n0, kc):
    """The 128 x 32 tile (rows n0.., K columns 32 kc..) of a parts array as
    two TMA boxes of 64 rows x 32 floats land with the 128-byte swizzle:
    row rr's 16-byte chunk c at rr * 128 + (c ^ (rr % 8)) * 16 of its box;
    outside the array reads as zero. Returns the 16 KB as floats and how
    many times each slot was written."""
    img, hits = np.zeros(BN * BK, np.float32), np.zeros(BN * BK, np.int64)
    n, k = part.shape
    for box in range(2):
        for rr in range(64):
            row = n0 + 64 * box + rr
            for c in range(BK // 4):
                at = (box * 8192 + rr * 128 + ((c ^ (rr & 7)) << 4)) // 4
                for e in range(4):
                    col = 32 * kc + 4 * c + e
                    img[at + e] = part[row, col] if row < n and col < k else 0
                    hits[at + e] += 1
    return img, hits


def _b_read(img, nrow, kcol):
    """The value a K-major 128-byte-swizzled wgmma B operand reads for its
    row nrow (0..127) and K column kcol (0..31): the descriptor at the
    tile's base plus kk * 32 bytes, 8-row groups 1024 bytes apart."""
    return img[(nrow * 128 + (((kcol >> 2) ^ (nrow & 7)) << 4) + (kcol & 3) * 4) // 4]


# (K, N) of W stored (K, N) (the dX products) or (N, K) (the LayerNorm
# products): ragged K (K % 32 = 8) and N (N % 128 = 4) among them
SPLIT_SHAPES = [(40, 132, True), (200, 260, True), (72, 4, True), (96, 256, True),
                (40, 132, False), (200, 260, False)]


@pytest.mark.parametrize("k,n,transposed", SPLIT_SHAPES)
def test_split_parts_land_once_in_the_swizzled_k_major_tiles(k, n, transposed):
    """The pre-pass writes every (n, k) of W^T's (or W's) parts exactly
    once, hi + lo within 2^-22 of it; each stage's two TMA boxes fill every
    slot of the 16 KB tile once, and what the consumers' B descriptor reads
    for (row, K column) is that element's part (zero past N and K)."""
    rng = np.random.default_rng(k * 1000 + n)
    w = (rng.standard_normal((k, n) if transposed else (n, k)) * k ** -0.5).astype(np.float32)
    wt = w.T if transposed else w  # (N, K): what the parts hold
    hi, lo, writes = _split_pass(w, transposed)
    assert np.all(writes == 1)
    for part in (hi, lo):
        assert not np.any(part.view(np.uint32) & np.uint32(0x1FFF))
    err = np.abs(wt.astype(np.float64) - (hi.astype(np.float64) + lo.astype(np.float64)))
    assert np.all(err <= 2.0 ** -22 * np.abs(wt.astype(np.float64)))
    for n0 in range(0, n, BN):
        for kc in range(-(-k // BK)):
            for part in (hi, lo):
                img, hits = _stage_image(part, n0, kc)
                assert np.all(hits == 1)
                rows, cols = np.meshgrid(np.arange(BN), np.arange(BK), indexing="ij")
                got = _b_read(img, rows, cols)
                rr, cc = n0 + rows, BK * kc + cols
                inside = (rr < n) & (cc < k)
                want = np.where(inside, part[np.minimum(rr, n - 1), np.minimum(cc, k - 1)], 0)
                np.testing.assert_array_equal(got, want)


def _warp_sum(v):
    """common.cuh's warp_sum: a butterfly over the 32 lanes' float32 values."""
    v = v.copy()
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    return v[0]


def _row_pass(x, scale, shift):
    """ln_rows_kernel's arithmetic on the host: lane l sums the float4
    chunks l, l + 32, .. of its row, each as (x + y) + (z + w), in float32;
    the warp's butterfly; mean = sum / K; the same for the squared
    deviations; rstd = 1 / sqrt(var + 1e-5); then ((x - mean) * rstd) *
    scale + shift, each step rounded to float32."""
    m, k = x.shape
    out = np.empty_like(x)
    f = np.float32
    for i in range(m):
        v = x[i].reshape(-1, 4)
        sums, sq = np.zeros(32, f), np.zeros(32, f)
        for lane in range(32):
            for c in range(lane, k // 4, 32):
                sums[lane] = f(sums[lane] + f(f(v[c, 0] + v[c, 1]) + f(v[c, 2] + v[c, 3])))
        mu = f(_warp_sum(sums) / f(k))
        for lane in range(32):
            for c in range(lane, k // 4, 32):
                d = (v[c] - mu).astype(f)
                sq[lane] = f(sq[lane] + f(f(d[0] * d[0] + d[1] * d[1])
                                          + f(d[2] * d[2] + d[3] * d[3])))
        rs = f(1) / np.sqrt(f(_warp_sum(sq) / f(k)) + f(1e-5))
        out[i] = (((x[i] - mu) * rs).astype(f) * scale + shift).astype(f)
    return out


@pytest.mark.parametrize("m,k", [(37, 768), (5, 200), (9, 1024), (3, 40)])
def test_row_pass_matches_the_plain_rows(m, k):
    """The row pass's rows (the kernel's order of sums) against the rows
    `fs.ln_gemm_plain(..., return_xn=True)` returns and the numpy float32
    LayerNorm: within a few float32 roundings of the rows' size (rsqrtf and
    the order of the sums differ; the card holds the whole mode within 1e-5
    rel-L2)."""
    rng = np.random.default_rng(m + k)
    x = (rng.standard_normal((m, k)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    shift = (0.1 * rng.standard_normal(k)).astype(np.float32)
    got = _row_pass(x, scale, shift)
    w = torch.from_numpy((rng.standard_normal((8, k)) * k ** -0.5).astype(np.float32))
    _, rows = fs.ln_gemm_plain(torch.from_numpy(x), w,
                               ln=(torch.from_numpy(scale), torch.from_numpy(shift)),
                               return_xn=True)
    tol = 8 * np.finfo(np.float32).eps * np.abs(got).max()
    np.testing.assert_allclose(got, rows.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(got, _layer_norm(x, scale, shift), rtol=0, atol=tol)


# the 256 px layer's training-mode products, (name, K, N, LayerNorm rows)
PRODUCTS = [("dX of Q", 768, 64, False), ("dX of K/V", 1536, 64, False),
            ("dX of QKV", 2304, 64, False), ("dX of expand", 3072, 64, False),
            ("dX of contract", 768, 128, False), ("LN1 -> QKV + rows", 768, 64, True)]


@pytest.mark.parametrize("name,k,n,rows", PRODUCTS, ids=[p[0] for p in PRODUCTS])
def test_training_mode_schedule_is_float32_accurate(name, k, n, rows):
    """A training mode's product as the card runs it: A (dY, or the row
    pass's rows) split per fragment, W's parts from the pre-pass, three
    TF32 products per 8-deep step added with truncation into a fresh
    partial per 32-deep stage, each stage's partial added into the sum with
    rounding, in stage order (the turns interleave the two warpgroups'
    stages, not one warpgroup's): within a quarter of the card's 1e-5
    against float64, and within 4x a plain float32 product's error."""
    rng = np.random.default_rng(k + n)
    if rows:
        x = rng.standard_normal((64, k)).astype(np.float32)
        a = _row_pass(x, (1 + 0.1 * rng.standard_normal(k)).astype(np.float32),
                      (0.1 * rng.standard_normal(k)).astype(np.float32))
        stored = (rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)
        w_nk = stored
    else:
        a = (rng.standard_normal((64, k)) * 1e-2).astype(np.float32)
        stored = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)  # W (K, N)
        w_nk = stored.T
    # the pre-pass's parts are those the product takes (tc_product splits w_nk^T alike)
    hi, lo, _ = _split_pass(stored, not rows)
    np.testing.assert_array_equal(hi, tf32_parts(w_nk)[0])
    np.testing.assert_array_equal(lo, tf32_parts(w_nk)[1])
    ref = a.astype(np.float64) @ w_nk.T.astype(np.float64)
    got = _rel(tc_product(a, w_nk.T, flush=BK), ref)
    plain = _rel(a @ w_nk.T, ref)
    assert got <= MARGIN * F32_KERNEL_REL_L2, (name, got, plain)
    assert got <= 4 * plain + 1e-7, (name, got, plain)


def _run_turns(units, nk):
    """The product kernel's protocol as a state machine: the producer fills
    stage position p (p % 4 of the ring) once both warpgroups have released
    p - 4; warpgroup w's run i (its stage i: wait for the stage to land,
    split, take the turn, issue, pass) alternates with the other's, 0
    first; a warpgroup releases a stage when its run's products are done,
    which is before its next run. Returns the positions each warpgroup
    flushed, in order."""
    total = units * nk
    released = {0: set(), 1: set()}
    flushed = {0: [], 1: []}
    filled, nxt, turn = 0, {0: 0, 1: 0}, 0
    while min(nxt.values()) < total:
        progressed = False
        while filled < total and (filled < STAGES
                                  or all(filled - STAGES in released[w] for w in (0, 1))):
            filled, progressed = filled + 1, True
        w = turn
        if nxt[w] < total and nxt[w] < filled:
            p = nxt[w]
            released[w].add(p)
            flushed[w].append(p)
            nxt[w] += 1
            turn, progressed = 1 - w, True
        assert progressed, (units, nk, nxt, filled)
    return flushed


@pytest.mark.parametrize("units,nk", [(1, 1), (1, 2), (3, 1), (2, 24), (3, 72), (5, 96)])
def test_turns_over_the_ring_never_deadlock(units, nk):
    """Every stage of every unit is run and flushed by both warpgroups,
    each in stage order, for one-stage units, units shorter than the ring
    and the layer's K = 768 / 2304 / 3072 (24, 72, 96 stages)."""
    flushed = _run_turns(units, nk)
    for w in (0, 1):
        assert flushed[w] == list(range(units * nk))


@pytest.mark.parametrize("name", sorted(ab.EDITS))
def test_ab_variant_edits_apply_once(name):
    """Every edit of every variant of the A/B script still applies to the
    kernel's source exactly once, and leaves its new text there."""
    source = (_build.CSRC / ab.SOURCE).read_text()
    got = ab.variant_source(name)
    assert (got == source) == (not ab.EDITS[name])
    for old, new in ab.EDITS[name]:
        assert got.count(old) == 0 or old in new
        assert new == "" or new in got


def test_ab_script_binds_the_entry_point():
    """The A/B script calls any build's ltd_ln_gemm_f32 with the port's
    argument types, in the order the source declares them."""
    source = (_build.CSRC / ab.SOURCE).read_text()
    assert f"LTD_API int {ab.ENTRY}(" in source
    decl = source[source.index(f"LTD_API int {ab.ENTRY}("):]
    decl = decl[:decl.index(")")]
    assert decl.count(",") + 1 == len(_build.SIGNATURES[ab.ENTRY])
