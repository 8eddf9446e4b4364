"""The probes' two kernel modules on the CPU (no device):
`head_group_attention_plain` (S4's self-attention with a row max shared by
each group of heads, or the heads' scores summed; ops/layer_variants.py)
against an independent float64 numpy version, and `dwconv_gelu_route`,
which body of csrc/dwconv_gelu.cu runs each `dwconv_gelu` mode."""

import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.ops import layer_variants as lvar

HEADS, DH = 12, 64
# (group, summed): every group size that divides 12 heads, and the summed heads
MODES = [(1, False), (2, False), (3, False), (4, False), (6, False), (12, False), (12, True)]
# the float32 plain version against float64: p's bf16 rounding may fall the
# other way for a few probabilities (one bf16 step, 2^-8 of p)
REL_L2 = 1e-3


def _bf16(x):
    """Round to bf16 (nearest, ties to even) through float32, as float64."""
    f = np.ascontiguousarray(x, dtype=np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    r = (((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16).astype(np.uint32)
    return np.where(np.isnan(f), np.nan, r.view(np.float32).astype(np.float64))


def _reference(qkv, res, n, group, summed):
    """res + the variant's attention, head by head in float64: scores
    q k^T / 8; summed: one softmax of the heads' summed scores whose bf16 P
    weighs every head's V; else e = exp(s - M) with M the row max over the
    group's heads, p = e / (the head's own sum of e) rounded to bf16, P V."""
    b = qkv.shape[0] // n
    x = qkv.astype(np.float64).reshape(b, n, 3, HEADS, DH)
    out = res.astype(np.float64).reshape(b, n, HEADS, DH).copy()
    for i in range(b):
        q, k, v = x[i, :, 0], x[i, :, 1], x[i, :, 2]
        s = [q[:, h] @ k[:, h].T / 8 for h in range(HEADS)]
        if summed:
            t = sum(s)
            e = np.exp(t - t.max(1, keepdims=True))
            p = _bf16(e / e.sum(1, keepdims=True))
            for h in range(HEADS):
                out[i, :, h] += p @ v[:, h]
            continue
        for g0 in range(0, HEADS, group):
            m = np.max([s[h].max(1) for h in range(g0, g0 + group)], axis=0)[:, None]
            for h in range(g0, g0 + group):
                e = np.exp(s[h] - m)
                with np.errstate(invalid="ignore", divide="ignore"):
                    p = _bf16(e / e.sum(1, keepdims=True))
                out[i, :, h] += p @ v[:, h]
    return out.reshape(b * n, HEADS * DH)


def _inputs(b, n, seed):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b * n, 3 * HEADS * DH), np.float32) * 1.5)
    res = torch.from_numpy(rng.standard_normal((b * n, HEADS * DH), np.float32))
    return qkv.to(torch.bfloat16), res


def _plain(qkv, res, n, group, summed):
    got = lvar.head_group_attention_plain(qkv, res.clone(), HEADS, n, group, summed)
    return got.double().numpy()


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n", [1, 65, 256])
@pytest.mark.parametrize("group,summed", MODES)
def test_head_group_attention_plain_matches_float64(group, summed, n):
    """The plain version's update (output - residual) against the float64
    head-by-head version at every group size of 12 heads and summed, on a
    single token, a ragged 65 and a full 256: rel-L2 < REL_L2, no NaN."""
    qkv, res = _inputs(2, n, 100 * group + n + summed)
    want = _reference(qkv.float().numpy(), res.numpy(), n, group, summed)
    got = _plain(qkv, res, n, group, summed)
    base = res.double().numpy()
    assert not np.isnan(got).any()
    assert _rel_l2(got - base, want - base) < REL_L2


@pytest.mark.parametrize("group", [2, 3, 4, 6, 12])
def test_head_group_attention_plain_keeps_an_underflowed_head_nan(group):
    """A head whose scores all lie far below its group's max (query row 3,
    where head 0 scores 2048 on every key and the others near 0) sums to
    zero and gives NaN, as the TPU variants do: NaN in exactly the other
    heads of group 0 on that row, in both versions; every other value
    within REL_L2."""
    n = 65
    qkv, res = _inputs(1, n, group)
    q = qkv[:, :DH]          # head 0's q
    k = qkv[:, HEADS * DH:HEADS * DH + DH]  # head 0's k
    q.zero_()
    q[3] = 16.0
    k.fill_(16.0)
    want = _reference(qkv.float().numpy(), res.numpy(), n, group, False)
    got = _plain(qkv, res, n, group, False)
    nan = np.zeros_like(got, dtype=bool)
    nan[3, DH:group * DH] = True
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(np.isnan(want), nan)
    base = res.double().numpy()
    assert _rel_l2(got[~nan] - base[~nan], want[~nan] - base[~nan]) < REL_L2


@pytest.mark.parametrize("mode,n_heads", [("base", 12), ("packed", 12), ("paired", 12),
                                          ("onehead", 12), ("packed", 4), ("paired", 2)])
def test_attention_group_maps_each_mode(mode, n_heads):
    """S4's attention modes as (group, summed) of `head_group_attention`:
    base a group of one, paired of two, packed of every head, onehead the
    heads summed; every group divides the heads."""
    group, summed = lvar.attention_group(mode, n_heads)
    assert (group, summed) == {"base": (1, False), "packed": (n_heads, False),
                               "paired": (2, False), "onehead": (n_heads, True)}[mode]
    assert n_heads % group == 0


BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("mode,h,c,hw,route", [
    # every mode and grid the wrapper took before the probe modes moved
    # onto the TMA body, and where it runs now
    ("base", BF, F32, 16, ("tma", 0)), ("base", BF, F32, 41, ("tma", 8)),
    ("base", F32, F32, 16, ("tma", 0)), ("base", F32, F32, 32, ("tma", 8)),
    ("base", BF, BF, 16, ("tma", 0)), ("base", BF, BF, 20, ("tma", 0)),
    ("none", F32, F32, 16, ("pointwise", 0)), ("none", F32, F32, 28, ("pointwise", 0)),
    ("commuted", F32, F32, 16, ("tma", 0)), ("commuted", F32, F32, 28, ("tma", 0)),
    # grids those modes take now: the row bands, and "none" on any grid
    ("base", BF, BF, 41, ("tma", 8)), ("commuted", F32, F32, 32, ("tma", 8)),
    ("none", F32, F32, 100, ("pointwise", 0))])
def test_dwconv_gelu_route_runs_every_mode(mode, h, c, hw, route):
    """`dwconv_gelu_route` gives each accepted mode a body of
    csrc/dwconv_gelu.cu: the TMA body with `dwconv_gelu_body`'s band, or
    the pointwise pass for "none"."""
    assert fs.dwconv_gelu_route(hw, h, mode, c) == route


@pytest.mark.parametrize("hw,dtype", [(8, F32), (16, F32), (28, F32), (29, F32), (88, F32)])
def test_dwconv_gelu_commuted_runs_base_code(hw, dtype):
    """"commuted" sums in the TMA body's own order, so it takes base's body
    and band on every grid."""
    assert fs.dwconv_gelu_route(hw, dtype, "commuted") == fs.dwconv_gelu_route(hw, dtype)


@pytest.mark.parametrize("mode,h,c,hw", [
    ("none", BF, F32, 16), ("commuted", BF, F32, 16), ("none", F32, BF, 16),
    ("commuted", F32, BF, 16), ("base", F32, BF, 16), ("base", BF, torch.float16, 16),
    ("sideways", F32, F32, 16), ("base", F32, F32, 89)])
def test_dwconv_gelu_route_rejects_what_no_body_runs(mode, h, c, hw):
    """The probe modes take float32 h and c, a bf16 c bf16 h, and the TMA
    body a grid one of its bodies holds: anything else raises
    ValueError."""
    with pytest.raises(ValueError):
        fs.dwconv_gelu_route(hw, h, mode, c)
