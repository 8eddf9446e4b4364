"""`weight_grad`'s work plan (ops/fused_layer_vjp.py::weight_grad_plan), on
the CPU: the persistent grid of csrc/gemm_bwd.cu covers every (output tile,
64-row stage) exactly once, gives every SM the same number of stages to
within one, and sums a tile's split partials in M order. Pure Python; no
card, no jax."""

import pytest

from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv

# (N, K) of a flagship layer's five weight gradients: dW2, dW1, dWq, dWkv,
# dWqkv; M is the batch's token rows (128 x 256 at 256 px, 64 x 1024 at
# 512 px, 16 x 4096 at 1024 px), the cond rows 2 x 128, and ragged M
FIVE = [(32768, 768, 3072), (32768, 3072, 768), (32768, 768, 768), (256, 1536, 768),
        (32768, 2304, 768)]
# the five products at the widths 64 x n_heads the JAX package runs (D =
# 64, 192, 1024: ragged last tiles where N % 128 or K % 256 != 0)
WIDTHS = [(m, n, k) for d in (64, 192, 1024)
          for m, n, k in ((8192, d, 4 * d), (8192, 4 * d, d), (8192, d, d), (128, 2 * d, d),
                          (8192, 3 * d, d))]
SHAPES = FIVE + [(65536, n, k) for _, n, k in FIVE] + [
    (16, 1536, 768), (8192 + 32, 768, 3072), (8224, 256, 128), (100, 128, 384)] + WIDTHS + [
    (8192, n, k) for n in (64, 192, 576, 1024) for k in (64, 192, 576, 1024)]
SMS = [132, 114, 78, 7]


def _records(plan):
    return [rec for block in plan.segments for rec in block]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plan_covers_each_tile_stage_once(m, n, k, sms):
    """Every (tile, stage) is covered by exactly one segment; each stage
    starts inside M, so it is whole or its rows past M are masked by the
    tensor map (only the last stage of a ragged M)."""
    plan = lv.weight_grad_plan(m, n, k, sms)
    assert plan.tiles == -(-n // 128) * -(-k // 256)
    assert plan.depth == -(-m // 64)
    spans = {}
    for tr, tc, lo, cnt, _, _, _, tile in _records(plan):
        assert tile == tr * plan.tile_cols + tc and 0 <= tile < plan.tiles
        assert cnt > 0 and 0 <= lo and lo + cnt <= plan.depth
        assert lo * 64 < m
        spans.setdefault(tile, []).append((lo, lo + cnt))
    assert sorted(spans) == list(range(plan.tiles))
    for parts in spans.values():
        parts.sort()
        assert parts[0][0] == 0 and parts[-1][1] == plan.depth
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plan_balances_stages_over_sms(m, n, k, sms):
    """No tail wave. With at least WG_MIN_STAGES stages per SM: one block
    per SM, and the blocks' stages differ by at most one. With fewer: whole
    tiles, one block per tile up to one per SM, and the blocks' tiles
    differ by at most one (their stages by at most one tile's depth)."""
    plan = lv.weight_grad_plan(m, n, k, sms)
    per_block = [sum(rec[3] for rec in block) for block in plan.segments]
    assert plan.blocks == len(plan.segments)
    assert sum(per_block) == plan.tiles * plan.depth
    if plan.tiles * plan.depth >= lv.WG_MIN_STAGES * sms:
        assert plan.blocks == sms
        assert max(per_block) - min(per_block) <= 1
    else:
        assert plan.blocks == min(sms, plan.tiles) and plan.slabs == 0
        assert all(rec[2] == 0 and rec[3] == plan.depth for rec in _records(plan))
        assert max(per_block) - min(per_block) <= plan.depth


def test_plan_of_the_five_products_at_132_sms():
    """At the flagship layer's batch 128 on 132 SMs: the four 32768-row
    products are stream-K over 132 blocks, 2 M-splits, stages within one;
    dWkv's 256 cond rows are 36 whole tiles of 4 stages."""
    for m, n, k in FIVE:
        plan = lv.weight_grad_plan(m, n, k, 132)
        per_block = [sum(rec[3] for rec in block) for block in plan.segments]
        if m == 256:
            assert (plan.blocks, plan.splits, set(per_block)) == (36, 1, {4})
        else:
            assert plan.blocks == 132 and plan.splits == 2
            assert max(per_block) - min(per_block) <= 1


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plan_orders_each_tiles_partials(m, n, k, sms):
    """A tile of one segment is written directly (no slab); a tile of
    several has one slab per segment, contiguous from its first slab, in
    the order of the segments' first rows, and the slabs of all tiles are
    distinct. The kernel's table holds the same records."""
    plan = lv.weight_grad_plan(m, n, k, sms)
    by_tile = {}
    for rec in _records(plan):
        by_tile.setdefault(rec[7], []).append(rec)
    used = set()
    for recs in by_tile.values():
        recs.sort(key=lambda r: r[2])
        nseg = len(recs)
        assert all(r[6] == nseg for r in recs)
        assert [r[5] for r in recs] == list(range(nseg))
        if nseg == 1:
            assert recs[0][4] == -1
            continue
        first = recs[0][4]
        assert first >= 0 and all(r[4] == first for r in recs)
        slabs = set(range(first, first + nseg))
        assert not slabs & used
        used |= slabs
    assert len(used) == plan.slabs
    table = plan.table()
    assert table[0] == 0 and table[plan.blocks] == len(_records(plan))
    assert len(table) == plan.blocks + 1 + lv.WG_RECORD * len(_records(plan))


def test_plan_keeps_sms_on_the_same_rows():
    """At 132 SMs the (768, 3072) product's SMs start within one split of
    each other's rows: each runs its pieces by their offset in their split,
    and the offsets of the first pieces are within 2 stages of 0 or of the
    pieces' split boundary. This is what lets L2 serve the tiles that share
    rows of dY and X."""
    plan = lv.weight_grad_plan(32768, 768, 3072, 132)
    split = plan.depth // plan.splits
    first_offsets = [block[0][2] % split for block in plan.segments]
    assert max(first_offsets) <= 2 * plan.depth // plan.blocks


@pytest.mark.parametrize("m,n,k", [(0, 128, 128), (64, 100, 128), (64, 128, 60)])
def test_plan_rejects_shapes_the_kernel_does_not_take(m, n, k):
    with pytest.raises(ValueError):
        lv.weight_grad_plan(m, n, k, 132)
