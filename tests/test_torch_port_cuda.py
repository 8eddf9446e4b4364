"""The port's hand-written CUDA kernels against their plain versions on the
card, at small shapes with inputs from a seed. The file imports only
torch, numpy, pytest and the port (no jax, no JAX package), so it runs on
a machine with a card and no jax:

    python3 -m pytest tests/test_torch_port_cuda.py -q --noconftest

(`--noconftest`: tests/conftest.py sets jax up for the rest of the
suite). Every test carries the `cuda` marker and skips where
torch.cuda.is_available() is false; `chip_smoke.py` checks the same
kernels at the main path's shapes."""

import math

import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu_torch.ops import attention as att
from transformer_latent_diffusion_tpu_torch.ops import fused_attn_vjp as k6
from transformer_latent_diffusion_tpu_torch.ops import fused_block as fb
from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
from transformer_latent_diffusion_tpu_torch.ops import fused_mlp_vjp as fm
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.ops import fused_stack_f32 as f32
from transformer_latent_diffusion_tpu_torch.ops import fused_stack_int8 as q8
from transformer_latent_diffusion_tpu_torch.ops import layer_variants as lvar


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (no interpret mode for CUDA kernels)")


def _rel_l2(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _tuple(v):
    return v if isinstance(v, tuple) else (v,)


# ------------------------------ K1 ------------------------------


def _stage_args(name, device):
    g = torch.Generator().manual_seed(1)
    b, hw, d, heads = 2, 8, 128, 2
    n = hw * hw

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device=device, dtype=dtype)

    bf = torch.bfloat16
    if name == "ln_gemm":
        return (r(b * n, d), r(3 * d, d, dtype=bf)), {"ln": (r(d), r(d))}
    if name == "self_attention":
        return (r(b * n, 3 * d, dtype=bf), r(b * n, d), heads, n), {}
    if name == "cross_attention":
        return (r(b * n, d, dtype=bf), r(2 * b, 2 * d, dtype=bf), r(b * n, d),
                (r(d), r(d)), heads, n), {}
    return (r(b * n, 4 * d, dtype=bf), r(9, 4 * d, dtype=bf), r(4 * d), hw), {}


@pytest.mark.cuda
@pytest.mark.parametrize("name", fs.KERNELS)
def test_kernel_matches_plain_on_card(name):
    """The CUDA kernel against its plain version on the card, at the tiny
    shapes above: bf16 outputs may differ by one rounding step, so rel-L2
    below 1e-2 for every output."""
    _need_card()
    args, kw = _stage_args(name, "cuda")
    plain_args = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    want = getattr(fs, f"{name}_plain")(*plain_args, **kw)
    before = fs.LAUNCHES[name]
    got = getattr(fs, name)(*args, **kw)
    torch.cuda.synchronize()
    assert fs.LAUNCHES[name] == before + 1
    for g, w in zip(_tuple(got), _tuple(want)):
        assert _rel_l2(g.float(), w.float()) < 1e-2


# ------------------------------ K2's backward kernels ------------------------------


def _kernel_cases(dev):
    """(name, kernel call, plain call) of every K2 backward kernel at a
    small shape on `dev`, inputs from a seed."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    bb, n, d, heads, hid = 32, 256, 128, 2, 256

    def rnd(*s, dtype=torch.float32, std=1.0):
        return (torch.randn(*s, generator=gen) * std).to(dev, dtype)

    m = bb * n
    bf = torch.bfloat16
    dy, xx = rnd(m, 256, dtype=bf), rnd(m, 128, dtype=bf)
    da, c, h = rnd(m, hid), rnd(m, hid), rnd(m, hid)
    dw = rnd(9, hid, dtype=bf, std=1 / 3)
    x, ups, sc = rnd(m, d), rnd(m, d), 1 + rnd(d, std=0.1)
    qkv, dout = rnd(m, 3 * d, dtype=bf), rnd(m, d)
    kv = rnd(2 * bb, 2 * d, dtype=bf)
    return [
        ("weight_grad", lambda: lv.weight_grad(dy, xx),
         lambda: lv.weight_grad_plain(dy, xx)),
        ("colsum", lambda: lv.colsum(da), lambda: lv.colsum_plain(da)),
        ("layernorm_bwd", lambda: lv.layernorm_bwd(dout, x, sc, ups),
         lambda: lv.layernorm_bwd_plain(dout, x, sc, ups)),
        ("dwconv_gelu_bwd", lambda: lv.dwconv_gelu_bwd(da, c, h, dw, 16),
         lambda: lv.dwconv_gelu_bwd_plain(da, c, h, dw, 16)),
        ("self_attention_bwd", lambda: lv.self_attention_bwd(qkv, dout, heads, n),
         lambda: lv.self_attention_bwd_plain(qkv, dout, heads, n)),
        ("cross_attention_bwd",
         lambda: lv.cross_attention_bwd(qkv[:, :d].contiguous(), kv, dout, heads, n),
         lambda: lv.cross_attention_bwd_plain(qkv[:, :d].contiguous(), kv, dout,
                                              heads, n)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["weight_grad", "colsum", "layernorm_bwd",
                                  "dwconv_gelu_bwd", "self_attention_bwd",
                                  "cross_attention_bwd"])
def test_kernel_matches_plain_on_cuda(name):
    """Each backward kernel against its plain version on the card: rel-L2
    < 1e-2 per output (bf16 outputs may differ by one rounding step)."""
    _need_card()
    kern, plain = next((k, p) for n, k, p in _kernel_cases("cuda") if n == name)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    for u, v in zip(_tuple(got), _tuple(want)):
        assert _rel_l2(u.float(), v.float()) < 1e-2


# ------------------------------ K3, K4, K5 ------------------------------


def _mlp_inputs(hw, d=64, hidden=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, hw * hw, d)).astype(np.float32),
            (rng.standard_normal((d, hidden)) * d ** -0.5).astype(np.float32),
            (rng.standard_normal(hidden) * 0.1).astype(np.float32),
            (rng.standard_normal((9, hidden)) / 3).astype(np.float32),
            (rng.standard_normal(hidden) * 0.1).astype(np.float32),
            (rng.standard_normal((hidden, d)) * hidden ** -0.5).astype(np.float32),
            (rng.standard_normal(d) * 0.1).astype(np.float32))


def _port_mlp_args(x, w1, b1, dw, dwb, w2, b2, dtype, device="cpu"):
    """The (in, out) layouts above in the port's: (out, in) products,
    float32 biases."""
    def t(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    return (t(x), t(w1.T), t(b1, torch.float32), t(dw), t(dwb, torch.float32),
            t(w2.T), t(b2, torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 400, 1024])
def test_flash_attention_matches_plain_on_card(n):
    """K3's kernel against attention_plain on the fused QKV rows (strided
    q, k, v views): bf16 output within rel-L2 1e-2 and max-abs 2e-2 of the
    output's scale (p is rounded at another point, see the kernel)."""
    _need_card()
    qkv = torch.randn(2, n, 3 * 128, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    before = att.LAUNCHES["flash_attention"]
    with torch.no_grad():
        got = att.flash_attention(q, k, v, 2).float()
        want = att.multi_head_attention(q, k, v, 2)
    torch.cuda.synchronize()
    assert att.LAUNCHES["flash_attention"] == before + 1
    want = want.float()
    assert float((got - want).norm() / want.norm()) < 1e-2
    assert float((got - want).abs().max()) < 2e-2 * float(want.abs().max())
    # with a gradient asked for, the same forward through FlashAttentionFunction
    q.requires_grad_(True)
    out = att.flash_attention(q, k, v, 2)
    assert float((out.detach().float() - got).abs().max()) == 0.0


@pytest.mark.cuda
def test_fused_mlp_sepconv_and_band_body_match_plain_on_card():
    """K5's forward at hw = 32 (float32 h through the row-band body of
    dwconv_gelu) against its plain version: rel-L2 below 1e-2. D = 128:
    ln_gemm's output width is a multiple of 128."""
    _need_card()
    args = _port_mlp_args(*_mlp_inputs(32, d=128), torch.bfloat16, "cuda")
    with torch.no_grad():
        got = fm.fused_mlp_sepconv(*args, 32).float()
        want = fm.fused_mlp_sepconv_plain(*args, 32).float()
        h = torch.randn(2 * 32 * 32, 256, device="cuda")
        band = fs.dwconv_gelu(h, args[3], args[4], 32).float()
        band_want = fs.dwconv_gelu_plain(h, args[3], args[4], 32).float()
    torch.cuda.synchronize()
    assert float((got - want).norm() / want.norm()) < 1e-2
    assert float((band - band_want).norm() / band_want.norm()) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 1024, 576, 1536, 4096])
def test_flash_attention_bwd_matches_plain_on_card(n):
    """K4 (`flash_attention_bwd`, after the forward with its log-sum-exp)
    against `attention_bwd_plain` on the fused QKV rows: dq, dk, dv each
    within rel-L2 1e-2 (D = rowsum(g o) from the bf16 output, and bf16
    outputs). Batch 2 at K4a's 512 and 1024 tokens; batch 1 at 576 (a
    ragged last 128-row block), 1536 and 4096 (K4b's range)."""
    _need_card()
    b = 2 if n in (512, 1024) else 1
    qkv = torch.randn(b, n, 3 * 128, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    g = torch.randn(b, n, 128, device="cuda").to(torch.bfloat16)
    o, lse = att._flash_forward(q, k, v, 2, with_lse=True)
    got = att.flash_attention_bwd(q, k, v, g, 2, o=o, lse=lse)
    want = att.flash_attention_bwd(*(t.cpu() for t in (q, k, v, g)), 2)
    torch.cuda.synchronize()
    for u, w in zip(got, want):
        assert _rel_l2(u.float(), w.float()) < 1e-2


@pytest.mark.cuda
def test_fused_mlp_sepconv_bwd_matches_plain_on_card():
    """K5's backward at hw = 32 (the row-band dwconv_gelu_bwd body) against
    `fused_mlp_sepconv_bwd_plain`: each of the 7 outputs within rel-L2
    1e-2. D = 128: weight_grad's and ln_gemm's output widths are multiples
    of 128."""
    _need_card()
    args = _port_mlp_args(*_mlp_inputs(32, d=128), torch.bfloat16, "cuda")
    g = torch.randn(args[0].shape, device="cuda").to(torch.bfloat16)
    x, w1, b1, dw, dwb, w2, _ = args
    got = fm.fused_mlp_sepconv_bwd(x, g, w1, b1, dw, dwb, w2, 32)
    want = fm.fused_mlp_sepconv_bwd_plain(x, g, w1, b1, dw, dwb, w2, 32)
    torch.cuda.synchronize()
    for u, w in zip(got, want):
        assert _rel_l2(u.float(), w.float()) < 1e-2
    assert math.isfinite(float(got[0].float().sum()))


# ------------------------------ K7 ------------------------------


def _int8_stage_args(name, device):
    g = torch.Generator().manual_seed(6)
    m, k, n = 64, 256, 384

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device=device, dtype=dtype)

    if name == "rowquant":
        return (r(m, k),), {"ln": (r(k), r(k))}
    xq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).to(device)
    wq = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).to(device)
    return (xq, r(m, 1).abs(), wq, r(1, n).abs()), {"bias": r(n), "residual": r(m, n)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", q8.KERNELS)
def test_int8_kernel_matches_plain_on_card(name):
    """The CUDA kernel against its plain version on the card, at the small
    shapes above: gemm_i8 on the same int8 operands is exact by
    construction (integer sums, the same float32 epilogue roundings);
    rowquant's LayerNorm statistics are summed in another order, so int8
    values within 1 in under 0.1% of elements and scales within 1e-6."""
    _need_card()
    args, kw = _int8_stage_args(name, "cuda")
    kw_plain = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    want = getattr(q8, f"{name}_plain")(*args, **kw_plain)
    before = q8.LAUNCHES[name]
    got = getattr(q8, name)(*args, **kw)
    torch.cuda.synchronize()
    assert q8.LAUNCHES[name] == before + 1
    if name == "gemm_i8":
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    else:
        diff = (got[0].int() - want[0].int()).abs()
        assert diff.max() <= 1 and (diff > 0).float().mean() < 1e-3
        torch.testing.assert_close(got[1], want[1], atol=0, rtol=1e-6)


# ------------------------------ the ragged tile, K6, K8, K9 ------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [144, 200, 37])
def test_ragged_self_attention_matches_plain_on_card(n):
    """self_attention and self_attention_bwd on a token count that is not a
    multiple of 64 (the ragged last tile: keys past N masked, rows past N
    neither read nor written) against their plain versions: rel-L2 below
    1e-2; the rows of the next batch element stay untouched."""
    _need_card()
    gen = torch.Generator().manual_seed(n)
    b, d, heads = 3, 128, 2
    qkv = torch.randn(b * n, 3 * d, generator=gen).to("cuda", torch.bfloat16)
    res = torch.randn(b * n, d, generator=gen).to("cuda")
    dout = torch.randn(b * n, d, generator=gen).to("cuda")
    want = fs.self_attention_plain(qkv, res.clone(), heads, n)
    got = fs.self_attention(qkv, res.clone(), heads, n)
    dwant = lv.self_attention_bwd_plain(qkv, dout, heads, n)
    dgot = lv.self_attention_bwd(qkv, dout, heads, n)
    torch.cuda.synchronize()
    assert _rel_l2(got, want) < 1e-2
    assert _rel_l2(dgot.float(), dwant.float()) < 1e-2
    for t in (got, dgot):
        assert torch.isfinite(t.float()).all()


def _k6_inputs(b, n, d=128, seed=0):
    gen = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16

    def r(*s, std=1.0, dtype=torch.float32, base=0.0):
        return (base + torch.randn(*s, generator=gen) * std).to("cuda", dtype)

    return [r(b, n, d, dtype=bf), r(b, 2, d, dtype=bf), r(d, std=0.1, base=1.0),
            r(d, std=0.1), r(3 * d, d, std=d ** -0.5, dtype=bf), r(d, std=0.1, base=1.0),
            r(d, std=0.1), r(d, d, std=d ** -0.5, dtype=bf),
            r(2 * d, d, std=d ** -0.5, dtype=bf)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 200])
def test_attention_pair_vjp_matches_plain_on_card(n):
    """K6's forward and its nine gradients through the kernels against the
    written-out plain versions on the same inputs: the layer's update and
    every gradient within rel-L2 2e-2 (the bf16 intermediates' one-step
    flips through two attentions and two LayerNorms)."""
    _need_card()
    args = _k6_inputs(4, n)
    g = (torch.randn(4, n, 128, generator=torch.Generator().manual_seed(1)) * 0.1).to(
        "cuda", torch.bfloat16)
    before = dict(k6.LAUNCHES)
    out = k6.fused_attention_pair_fwd(*args, 2)
    want = k6.fused_attention_pair_fwd_plain(*args, 2)
    grads = k6.fused_attention_pair_bwd(args[0], args[1], g, *args[2:], 2)
    gwant = k6.fused_attention_pair_bwd_plain(args[0], args[1], g, *args[2:], 2)
    torch.cuda.synchronize()
    assert k6.LAUNCHES["fused_attention_pair_vjp"] == before["fused_attention_pair_vjp"] + 1
    x = args[0].float()
    assert _rel_l2(out.float() - x, want.float() - x) < 2e-2
    for name, u, w in zip(("x", "cond") + k6.PARAM_NAMES, grads, gwant):
        assert _rel_l2(u.float(), w.float()) < 2e-2, name


@pytest.mark.cuda
def test_fused_block_entry_points_match_plain_on_card():
    """K8 (`fused_attention_pair`, the cond K/V given) and K9
    (`fused_mlp_sepconv`) through K1's kernels against their plain
    versions: the updates within rel-L2 1e-2."""
    _need_card()
    a = _k6_inputs(2, 256, seed=2)
    gen = torch.Generator().manual_seed(3)
    kc, vc = (torch.randn(2, 2, 128, generator=gen).to("cuda", torch.bfloat16)
              for _ in range(2))
    k8 = (a[0], *a[2:7], a[7], kc, vc)
    x = a[0].float()
    got, want = fb.fused_attention_pair(*k8, 2), fb.fused_attention_pair_plain(*k8, 2)
    assert _rel_l2(got.float() - x, want.float() - x) < 1e-2
    m = _port_mlp_args(*_mlp_inputs(16, d=128, hidden=512), torch.bfloat16, "cuda")
    k9 = (m[0], a[2], a[3], m[1], m[2], m[3], m[4], m[5], m[6])
    x = m[0].float()
    got, want = fb.fused_mlp_sepconv(*k9, 16), fb.fused_mlp_sepconv_plain(*k9, 16)
    torch.cuda.synchronize()
    assert _rel_l2(got.float() - x, want.float() - x) < 1e-2


# ------------------------------ the probes S3, S2, S4 ------------------------------

S3_FORMS = [(e2, pd) for e2 in (False, True) for pd in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("use_exp2,postdiv", S3_FORMS)
@pytest.mark.parametrize("n", [1000, 256])
def test_flash_attention_variant_matches_plain_on_card(n, use_exp2, postdiv):
    """S3's four softmax forms against `attention_variant_plain`, on the
    probe's (B*H, N, 64) head rows (one head per row block) and on fused
    QKV rows (strided, two heads): rel-L2 < 1e-2 and max-abs < 2e-2 of the
    output's scale (postdiv rounds e against a running max)."""
    _need_card()
    gen = torch.Generator().manual_seed(n)
    q, k, v = (torch.randn(2 * 3, n, 64, generator=gen).to("cuda", torch.bfloat16)
               for _ in range(3))
    qkv = torch.randn(2, n, 3 * 128, generator=gen).to("cuda", torch.bfloat16)
    before = att.LAUNCHES["flash_attention_variant"]
    for args, heads in (((q, k, v), 1), (qkv.chunk(3, dim=-1), 2)):
        got = att.flash_attention_variant(*args, heads, use_exp2, postdiv).float()
        want = att.attention_variant_plain(*args, heads, use_exp2, postdiv).float()
        torch.cuda.synchronize()
        assert _rel_l2(got, want) < 1e-2
        assert float((got - want).abs().max()) < 2e-2 * float(want.abs().max())
    assert att.LAUNCHES["flash_attention_variant"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("group,summed", [(1, False), (2, False), (3, False), (4, False),
                                          (6, False), (12, False), (12, True)])
@pytest.mark.parametrize("n,b", [(1, 3), (64, 3), (65, 3), (200, 3), (256, 3), (200, 137)])
def test_head_group_attention_matches_plain_on_card(n, b, group, summed):
    """S4's attention kernel at 12 heads (every group size that divides
    them, and the heads summed) on one token, a full tile, ragged tiles and
    256 tokens, and at batch 137, which leaves a partial last wave of the
    persistent grid on 132 SMs, against its plain version: rel-L2 < 1e-2;
    two launches bit-equal; a group of one within 1e-5 of the layer's own
    self_attention kernel."""
    _need_card()
    gen = torch.Generator().manual_seed(n + group + b)
    d, heads = 768, 12
    qkv = torch.randn(b * n, 3 * d, generator=gen).to("cuda", torch.bfloat16)
    res = torch.randn(b * n, d, generator=gen).to("cuda")
    want = lvar.head_group_attention_plain(qkv, res.clone(), heads, n, group, summed)
    before = lvar.LAUNCHES["head_group_attention"]
    got = lvar.head_group_attention(qkv, res.clone(), heads, n, group, summed)
    again = lvar.head_group_attention(qkv, res.clone(), heads, n, group, summed)
    torch.cuda.synchronize()
    assert lvar.LAUNCHES["head_group_attention"] == before + 2
    assert _rel_l2(got - res, want - res) < 1e-2
    assert torch.equal(got, again)
    if group == 1 and not summed:
        base = fs.self_attention(qkv, res.clone(), heads, n)
        assert _rel_l2(got - res, base - res) < 1e-5


@pytest.mark.cuda
def test_layer_kernel_modes_match_plain_on_card():
    """The probes' modes of K1's and K2's kernels against their plain
    versions: cross_attention with the heads summed, dwconv_gelu without
    the convolution and with it commuted (float32 h; commuted is base's
    walk, bit-equal to base on the whole grid and on the row bands of hw
    32), with a bf16 c (bf16 h, hw 16 and 20, and the row bands of hw 41),
    and layernorm_bwd and dwconv_gelu_bwd reading bf16 residuals: rel-L2 <
    1e-2 per output; every dwconv_gelu mode bit-equal across two
    launches."""
    _need_card()
    gen = torch.Generator().manual_seed(7)
    bf = torch.bfloat16
    b, hw, d, heads, hid = 4, 16, 256, 4, 512
    m = b * hw * hw

    def r(*s, std=1.0, dtype=torch.float32):
        return (torch.randn(*s, generator=gen) * std).to("cuda", dtype)

    def dw_check(h, grid, **kw):
        got = fs.dwconv_gelu(h, dw, dwb, grid, return_c=True, **kw)
        again = fs.dwconv_gelu(h, dw, dwb, grid, return_c=True, **kw)
        want = fs.dwconv_gelu_plain(h, dw, dwb, grid, return_c=True, **kw)
        for u, a, w in zip(got, again, want):
            assert u.dtype == w.dtype and _rel_l2(u.float(), w.float()) < 1e-2, kw
            assert torch.equal(u, a), kw
        return got

    qc, kv, res, lns = r(m, d, dtype=bf), r(2 * b, 2 * d, dtype=bf), r(m, d), (1 + r(d, std=0.1), r(d))
    got = fs.cross_attention(qc, kv, res.clone(), lns, heads, hw * hw, summed=True)
    want = fs.cross_attention_plain(qc, kv, res.clone(), lns, heads, hw * hw, summed=True)
    for u, w in zip(got, want):
        assert _rel_l2(u.float(), w.float()) < 1e-2
    dw, dwb = r(9, hid, std=1 / 3, dtype=bf), r(hid, std=0.1)
    for grid in (16, 32):
        h = r(b * grid * grid, hid)
        dw_check(h, grid, dw_mode="none")
        commuted = dw_check(h, grid, dw_mode="commuted")
        base = fs.dwconv_gelu(h, dw, dwb, grid, return_c=True)
        assert all(torch.equal(u, v) for u, v in zip(commuted, base))
    for grid in (16, 20, 41):
        got = dw_check(r(b * grid * grid, hid, dtype=bf), grid, c_dtype=bf)
        assert got[1].dtype == bf
    hb = r(m, hid, dtype=bf)
    dy, xb, ups, sc = r(m, d), r(m, d, dtype=bf), r(m, d), 1 + r(d, std=0.1)
    for u, w in zip(lv.layernorm_bwd(dy, xb, sc, ups), lv.layernorm_bwd_plain(dy, xb, sc, ups)):
        assert _rel_l2(u, w) < 1e-2
    da, cb = r(m, hid), r(m, hid, dtype=bf)
    got = lv.dwconv_gelu_bwd(da, cb, hb, dw, hw)
    want = lv.dwconv_gelu_bwd_plain(da, cb, hb, dw, hw)
    torch.cuda.synchronize()
    for u, w in zip(got, want):
        assert _rel_l2(u.float(), w.float()) < 1e-2


def _layer_args(b, hw, d=128, hidden=512, seed=0):
    """x, cond, g and the 15 layer parameters (PARAM_NAMES order, the
    port's layouts), bf16 activations and weights, float32 LayerNorm and
    biases."""
    gen = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16

    def r(*s, std=1.0, dtype=torch.float32, base=0.0):
        return (base + torch.randn(*s, generator=gen) * std).to("cuda", dtype)

    n = hw * hw
    params = [r(d, std=0.1, base=1.0), r(d, std=0.1), r(3 * d, d, std=d ** -0.5, dtype=bf),
              r(d, std=0.1, base=1.0), r(d, std=0.1), r(d, d, std=d ** -0.5, dtype=bf),
              r(2 * d, d, std=d ** -0.5, dtype=bf), r(d, std=0.1, base=1.0), r(d, std=0.1),
              r(hidden, d, std=d ** -0.5, dtype=bf), r(hidden, std=0.1),
              r(9, hidden, std=1 / 3, dtype=bf), r(hidden, std=0.1),
              r(d, hidden, std=hidden ** -0.5, dtype=bf), r(d, std=0.1)]
    return (r(b, n, d, dtype=bf), r(b, 2, d, dtype=bf), r(b, n, d, std=0.1, dtype=bf),
            params)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", lv.BWD_MODES)
def test_layer_bwd_variant_matches_plain_on_card(mode):
    """S2's backward modes through the kernels against their written-out
    plain versions: the same outputs computed (None where the mode skips
    one), each within rel-L2 2e-2 (as the K6 gradients: bf16
    intermediates' one-step flips through the layer)."""
    _need_card()
    x, cond, g, params = _layer_args(2, 16, seed=8)
    got = lv.fused_layer_bwd_variant(mode, x, cond, g, params, 2, 16)
    want = lv.fused_layer_bwd_variant_plain(mode, x, cond, g, params, 2, 16)
    torch.cuda.synchronize()
    names = ("x", "cond") + lv.PARAM_NAMES
    for name, u, w in zip(names, [got[0], got[1], *got[2]], [want[0], want[1], *want[2]]):
        assert (u is None) == (w is None), name
        if u is not None:
            assert _rel_l2(u.float(), w.float()) < 2e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("attn_mode,dw_mode", [
    ("base", "base"), ("base", "none"), ("base", "commuted"), ("onehead", "base"),
    ("packed", "base"), ("paired", "base"), ("packed", "commuted")])
def test_layer_fwd_variant_matches_plain_on_card(attn_mode, dw_mode):
    """S4's forward variants through the kernels against their plain
    versions: the layer's update within rel-L2 2e-2 (LAYER_REL_L2 of
    chip_smoke.py); base x base is the training forward itself."""
    _need_card()
    x, cond, _, params = _layer_args(2, 16, d=256, seed=9)
    got = lvar.fused_layer_fwd_variant(attn_mode, dw_mode, x, cond, params, 4, 16)
    want = lvar.fused_layer_fwd_variant_plain(attn_mode, dw_mode, x, cond, params, 4, 16)
    torch.cuda.synchronize()
    xf = x.float()
    assert _rel_l2(got.float() - xf, want.float() - xf) < 2e-2
    if (attn_mode, dw_mode) == ("base", "base"):
        ref = lv.fused_layer_fwd(x, cond, params, 4, 16)
        assert torch.equal(got, ref)


# ------------------------- the Hopper (TMA + wgmma) redesigns -------------------------


def _close(got, want):
    """rel-L2 < 1e-2 and max-abs < 2e-2 of the plain output's scale (the
    two sum the same bf16 products in float32 in other orders)."""
    got, want = got.double().cpu(), want.double().cpu()
    scale = float(want.abs().max())
    return (_rel_l2(got, want) < 1e-2
            and float((got - want).abs().max()) < 2e-2 * max(scale, 1e-30))


def _attention_inputs(b, n, d=128, pad=8, seed=0):
    """qkv (B*N, 3D) bf16, and a float32 residual of B*N rows followed by
    `pad` sentinel rows in the same allocation."""
    gen = torch.Generator().manual_seed(seed + n)
    qkv = torch.randn(b * n, 3 * d, generator=gen).to("cuda", torch.bfloat16)
    store = torch.randn(b * n + pad, d, generator=gen).to("cuda")
    return qkv, store


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 37, 64, 144, 200, 256])
def test_self_attention_update_matches_plain_on_card(n):
    """The TMA + wgmma self_attention at every query-tile count, ragged or
    whole: the update of the float32 residual against the plain version's
    (rel-L2 < 1e-2, max-abs < 2e-2 of its scale), and the rows after the
    last image, in the same allocation, untouched (a ragged tile's rows past
    N are clipped by the tensor map)."""
    _need_card()
    b, heads = 3, 2
    qkv, store = _attention_inputs(b, n)
    before = store.clone()
    res = store[:b * n]
    want = fs.self_attention_plain(qkv, before[:b * n].clone(), heads, n) - before[:b * n]
    fs.self_attention(qkv, res, heads, n)
    torch.cuda.synchronize()
    assert _close(res - before[:b * n], want)
    assert torch.equal(store[b * n:], before[b * n:])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 256])
def test_self_attention_is_bit_equal_across_launches(n):
    """Two launches on the same inputs give bit-equal residuals: each
    element has one writer and one float32 add."""
    _need_card()
    qkv, store = _attention_inputs(4, n)
    res = store[:4 * n]
    a, b2 = res.clone(), res.clone()
    fs.self_attention(qkv, a, 2, n)
    fs.self_attention(qkv, b2, 2, n)
    torch.cuda.synchronize()
    assert torch.equal(a, b2)


# (N, K) of the five weight gradients of a flagship layer: dW2, dW1, dWq,
# dWkv, dWqkv
WG_NK = [(768, 3072), (3072, 768), (768, 768), (1536, 768), (2304, 768)]


def _wg_inputs(m, n, k, seed=0):
    gen = torch.Generator().manual_seed(seed + m + n + k)
    dy = (torch.randn(m, n, generator=gen) * 1e-2).to("cuda", torch.bfloat16)
    x = torch.randn(m, k, generator=gen).to("cuda", torch.bfloat16)
    return dy, x


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 256, 8192 + 32])
@pytest.mark.parametrize("n,k", WG_NK)
def test_weight_grad_shapes_match_plain_on_card(m, n, k):
    """weight_grad at the five (N, K) classes and at M = 16, 256 and a
    ragged 8224 (the tensor map zero-fills the last stage past M): against
    its plain version, rel-L2 < 1e-2 and max-abs < 2e-2 of the scale."""
    _need_card()
    dy, x = _wg_inputs(m, n, k)
    got = lv.weight_grad(dy, x)
    want = lv.weight_grad_plain(dy, x)
    torch.cuda.synchronize()
    assert got.shape == (n, k) and got.dtype == torch.float32
    assert _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(32768, 768, 3072), (8192 + 32, 256, 128), (256, 1536, 768)])
def test_weight_grad_is_bit_equal_across_launches(m, n, k):
    """Two launches on the same inputs give bit-equal gradients: the split
    partials are summed in a fixed order, whichever block finishes last."""
    _need_card()
    dy, x = _wg_inputs(m, n, k, seed=1)
    first = lv.weight_grad(dy, x)
    second = lv.weight_grad(dy, x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# ------------------- ln_gemm and flash_attention on TMA + wgmma -------------------

LN_GEMM_M = [1, 4, 127, 129, 16384]
# K = 96 leaves half of the second 64-wide K box past K (zero-filled)
LN_GEMM_CASES = [(m, k, n, ln) for m in LN_GEMM_M for k in (96, 768, 3072)
                 for n in (128, 2304) for ln in (False, True) if not (ln and k > 768)]


def _gemm_inputs(m, k, n, ln, seed=0):
    """a (float32 with `ln`, else bf16), w (N, K) bf16, bias, LayerNorm."""
    gen = torch.Generator().manual_seed(seed + m + 7 * k + 13 * n)

    def r(*s, std=1.0, base=0.0):
        return base + torch.randn(*s, generator=gen) * std

    a = r(m, k, base=0.5).to("cuda", torch.float32 if ln else torch.bfloat16)
    w = r(n, k, std=k ** -0.5).to("cuda", torch.bfloat16)
    lnp = (r(k, std=0.1, base=1.0).cuda(), r(k, std=0.1).cuda()) if ln else None
    return a, w, r(n, std=0.1).cuda(), lnp


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,ln", LN_GEMM_CASES)
def test_ln_gemm_shapes_match_plain_on_card(m, k, n, ln):
    """ln_gemm's one body at M in {1, 4, 127, 129, 16384} (ragged row
    blocks), K in {96, 768, 3072} and N in {128, 2304}, with the LayerNorm
    prologue (K <= 768) and streaming: against its plain version (rel-L2
    < 1e-2, max-abs < 2e-2 of the scale), two launches bit-equal."""
    _need_card()
    a, w, _, lnp = _gemm_inputs(m, k, n, ln)
    want = fs.ln_gemm_plain(a, w, ln=lnp)
    before = fs.LAUNCHES["ln_gemm"]
    got = fs.ln_gemm(a, w, ln=lnp)
    again = fs.ln_gemm(a, w, ln=lnp)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["ln_gemm"] == before + 2
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert _close(got.float(), want.float())
    assert torch.equal(got, again)


LN_GEMM_MODES = ["ln_xn", "bias", "f32", "residual", "w_transposed", "w_transposed_ln_f32"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", LN_GEMM_MODES)
def test_ln_gemm_modes_match_plain_on_card(mode):
    """ln_gemm's epilogue and operand modes at M = 1000 (a ragged last row
    block), K = 768, N = 384: the LayerNorm rows out, bias, float32 out,
    the float32 residual update, and W given as (K, N) (`w_transposed`,
    the backward's dX products); each against its plain version, two
    launches bit-equal (the residual: from the same starting values)."""
    _need_card()
    m, k, n = 1000, 768, 384
    ln = mode in ("ln_xn", "w_transposed_ln_f32")
    a, w, bias, lnp = _gemm_inputs(m, k, n, ln, seed=3)
    kw = {"ln": lnp}
    if mode == "ln_xn":
        kw["return_xn"] = True
    if mode == "bias":
        kw["bias"] = bias
    if mode in ("f32", "w_transposed_ln_f32"):
        kw["out_dtype"] = torch.float32
    if mode.startswith("w_transposed"):
        w = w.T.contiguous()
        kw["w_transposed"] = True
    res = torch.randn(m, n, device="cuda") if mode == "residual" else None

    def run(fn):
        if res is not None:
            return (fn(a, w, bias=bias, residual=res.clone()) - res,)
        return _tuple(fn(a, w, **kw))

    want, got, again = run(fs.ln_gemm_plain), run(fs.ln_gemm), run(fs.ln_gemm)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for u, v in zip(got, want):
        assert u.shape == v.shape and u.dtype == v.dtype
        assert _close(u.float(), v.float())
    for u, v in zip(got, again):
        assert torch.equal(u, v)


FLASH_SHAPES = [(8, 8), (65, 65), (1000, 1000), (4096, 4096), (65, 1000), (1000, 8),
                (4096, 65)]


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk", FLASH_SHAPES)
def test_flash_attention_shapes_and_lse_on_card(nq, nk):
    """K3 at N in {8, 65, 1000, 4096} and with Nq != Nk (ragged query and
    key tiles): the output against attention_plain (rel-L2 < 1e-2, max-abs
    < 2e-2 of the scale), each row's log-sum-exp against the plain
    logsumexp of q k^T / 8 (max-abs < 1e-3: float32 sums of the same
    terms), and two launches bit-equal."""
    _need_card()
    gen = torch.Generator().manual_seed(nq + 3 * nk)
    b, heads, d = 2, 2, 128
    q = torch.randn(b, nq, d, generator=gen).to("cuda", torch.bfloat16)
    kv = torch.randn(b, nk, 2 * d, generator=gen).to("cuda", torch.bfloat16)
    k, v = kv.chunk(2, dim=-1)  # strided row views
    out, lse = att._flash_forward(q, k, v, heads, with_lse=True)
    again, lse2 = att._flash_forward(q, k, v, heads, with_lse=True)
    want = att._mha_plain(q, k, v, heads)
    qh, kh = att._heads(q, heads).float(), att._heads(k, heads).float()
    lse_want = torch.logsumexp(qh @ kh.transpose(-1, -2) / 8.0, dim=-1)
    torch.cuda.synchronize()
    assert _close(out.float(), want.float())
    assert float((lse - lse_want).abs().max()) < 1e-3
    assert torch.equal(out, again) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_flash_attention_is_the_exp2_postdiv_form_on_card():
    """K3 is the probe's exp2,postdiv form of the same kernel body: the
    two entry points give bit-equal outputs."""
    _need_card()
    qkv = torch.randn(2, 1000, 3 * 128, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    with torch.no_grad():
        k3 = att.flash_attention(q, k, v, 2)
        form = att.flash_attention_variant(q, k, v, 2, use_exp2=True, postdiv=True)
    torch.cuda.synchronize()
    assert torch.equal(k3, form)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 576])
def test_flash_attention_bwd_is_bit_equal_across_launches(n):
    """Two launches of K4's backward on the same inputs give bit-equal dq,
    dk and dv: each element has one writer and every sum a fixed order."""
    _need_card()
    gen = torch.Generator().manual_seed(n)
    qkv = torch.randn(2, n, 3 * 128, generator=gen).to("cuda", torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    g = torch.randn(2, n, 128, generator=gen).to("cuda", torch.bfloat16)
    o, lse = att._flash_forward(q, k, v, 2, with_lse=True)
    first = att.flash_attention_bwd(q, k, v, g, 2, o=o, lse=lse)
    second = att.flash_attention_bwd(q, k, v, g, 2, o=o, lse=lse)
    torch.cuda.synchronize()
    assert all(torch.equal(u, w) for u, w in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 256])
def test_self_attention_bwd_is_bit_equal_across_launches(n):
    """Two launches of self_attention_bwd on the same inputs give bit-equal
    dq, dk and dv rows."""
    _need_card()
    gen = torch.Generator().manual_seed(n)
    qkv = torch.randn(4 * n, 3 * 128, generator=gen).to("cuda", torch.bfloat16)
    dout = torch.randn(4 * n, 128, generator=gen).to("cuda")
    first = lv.self_attention_bwd(qkv, dout, 2, n)
    second = lv.self_attention_bwd(qkv, dout, 2, n)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_self_attention_bwd_partial_last_wave_on_card():
    """self_attention_bwd at batch 12 x 12 heads: 144 (batch, head) pairs on
    the persistent grid of one block per SM leave its last wave partial on
    an H100 (132 SMs). dq, dk and dv each within the kernel bound of the
    plain version; two launches bit-equal."""
    _need_card()
    gen = torch.Generator().manual_seed(12)
    b, n, heads = 12, 256, 12
    d = 64 * heads
    qkv = torch.randn(b * n, 3 * d, generator=gen).to("cuda", torch.bfloat16)
    dout = (torch.randn(b * n, d, generator=gen) * 1e-2).to("cuda")
    got = lv.self_attention_bwd(qkv, dout, heads, n)
    want = lv.self_attention_bwd_plain(qkv, dout, heads, n)
    again = lv.self_attention_bwd(qkv, dout, heads, n)
    torch.cuda.synchronize()
    for u, w in zip(got.split(d, -1), want.split(d, -1)):
        assert _close(u.float(), w.float())
    assert torch.equal(got, again)


# ------------- every width 64 x n_heads; gemm_i8 and dwconv_gelu on TMA -------------

WIDTHS = (64, 192, 1024)  # embed_dim: 1, 3 and 16 heads
WIDE_KERNELS = ("ln_gemm", "weight_grad", "layernorm_bwd", "cross_attention",
                "cross_attention_bwd", "rowquant", "gemm_i8")


def _width_cases(name, d):
    """(kernel call, plain call) pairs of `name` at embed_dim d: the shapes
    a layer of that width gives it (2 images of a 16 x 16 grid, ragged
    tiles wherever d % 128 != 0), inputs from a seed."""
    gen = torch.Generator().manual_seed(d)
    b, n, heads, hid = 2, 256, d // 64, 4 * d
    m = b * n

    def r(*s, std=1.0, base=0.0, dtype=torch.float32):
        return (base + torch.randn(*s, generator=gen) * std).to("cuda", dtype)

    bf = torch.bfloat16
    x, ln = r(m, d, base=0.5), (r(d, std=0.1, base=1.0), r(d, std=0.1))
    if name == "ln_gemm":
        xn, act, cond = r(m, d, dtype=bf), r(m, hid, dtype=bf), r(2 * b, d, dtype=bf)
        w = {k: r(nn, kk, std=kk ** -0.5, dtype=bf) for k, (nn, kk) in {
            "qkv": (3 * d, d), "q": (d, d), "kv": (2 * d, d), "w1": (hid, d),
            "w2": (d, hid)}.items()}
        b1, b2 = r(hid, std=0.1), r(d, std=0.1)
        return [
            (lambda: fs.ln_gemm(x, w["qkv"], ln=ln), lambda: fs.ln_gemm_plain(x, w["qkv"], ln=ln)),
            (lambda: fs.ln_gemm(x, w["q"], ln=ln, return_xn=True),
             lambda: fs.ln_gemm_plain(x, w["q"], ln=ln, return_xn=True)),
            (lambda: fs.ln_gemm(cond, w["kv"]), lambda: fs.ln_gemm_plain(cond, w["kv"])),
            (lambda: fs.ln_gemm(xn, w["w1"], bias=b1, out_dtype=torch.float32),
             lambda: fs.ln_gemm_plain(xn, w["w1"], bias=b1, out_dtype=torch.float32)),
            (lambda: fs.ln_gemm(act, w["w2"], bias=b2, residual=x.clone()) - x,
             lambda: fs.ln_gemm_plain(act, w["w2"], bias=b2, residual=x) - x),
            # the backward's dX = dY W: W (hid, d) read as stored
            (lambda: fs.ln_gemm(act, w["w1"], w_transposed=True, out_dtype=torch.float32),
             lambda: fs.ln_gemm_plain(act, w["w1"], w_transposed=True, out_dtype=torch.float32)),
        ]
    if name == "weight_grad":  # the five dW of a layer: dW2, dW1, dWq, dWkv, dWqkv
        pairs = [(r(m, nn, std=1e-2, dtype=bf), r(m, kk, dtype=bf))
                 for nn, kk in ((d, hid), (hid, d), (d, d), (2 * d, d), (3 * d, d))]
        return [(lambda p=p: lv.weight_grad(*p), lambda p=p: lv.weight_grad_plain(*p))
                for p in pairs]
    if name == "layernorm_bwd":
        dy, ups = r(m, d), r(m, d)
        return [(lambda: lv.layernorm_bwd(dy, x, ln[0], ups),
                 lambda: lv.layernorm_bwd_plain(dy, x, ln[0], ups))]
    qc, kv = r(m, d, dtype=bf), r(2 * b, 2 * d, dtype=bf)
    if name == "cross_attention":
        def update(out):  # the residual's update and the LN3 rows
            return (out[0] - x,) + ((out[1],) if out[1] is not None else ())

        return [(lambda: update(fs.cross_attention(qc, kv, x.clone(), ln, heads, n)),
                 lambda: update(fs.cross_attention_plain(qc, kv, x, ln, heads, n))),
                (lambda: update(fs.cross_attention(qc, kv, x.clone(), None, heads, n)),
                 lambda: update(fs.cross_attention_plain(qc, kv, x, None, heads, n)))]
    if name == "cross_attention_bwd":
        dout = r(m, d, std=0.1)
        return [(lambda: lv.cross_attention_bwd(qc, kv, dout, heads, n),
                 lambda: lv.cross_attention_bwd_plain(qc, kv, dout, heads, n))]
    if name == "rowquant":
        act = torch.nn.functional.gelu(r(m, hid))
        return [(lambda: q8.rowquant(x, ln), lambda: q8.rowquant_plain(x, ln)),
                (lambda: q8.rowquant(act), lambda: q8.rowquant_plain(act))]
    xq, rs = q8.rowquant_plain(x, ln)
    aq, ars = q8.rowquant_plain(torch.nn.functional.gelu(r(m, hid)))
    w = {k: q8.colquant(r(nn, kk, std=kk ** -0.5, dtype=bf)) for k, (nn, kk) in {
        "qkv": (3 * d, d), "q": (d, d), "w1": (hid, d), "w2": (d, hid)}.items()}
    b1, b2 = r(hid, std=0.1), r(d, std=0.1)
    return [
        (lambda: q8.gemm_i8(xq, rs, *w["qkv"]), lambda: q8.gemm_i8_plain(xq, rs, *w["qkv"])),
        (lambda: q8.gemm_i8(xq, rs, *w["q"]), lambda: q8.gemm_i8_plain(xq, rs, *w["q"])),
        (lambda: q8.gemm_i8(xq, rs, *w["w1"], bias=b1, out_dtype=torch.float32),
         lambda: q8.gemm_i8_plain(xq, rs, *w["w1"], bias=b1, out_dtype=torch.float32)),
        (lambda: q8.gemm_i8(aq, ars, *w["w2"], bias=b2, residual=x.clone()),
         lambda: q8.gemm_i8_plain(aq, ars, *w["w2"], bias=b2, residual=x)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("name", WIDE_KERNELS)
def test_widened_kernel_matches_plain_on_card(name, d):
    """Each kernel that took only the flagship's widths, at embed_dim 64,
    192 and 1024 (ragged N and K tiles, LayerNorm rows past 768, more than
    12 heads, rowquant rows past its 3072-wide register path) against its
    plain version: rel-L2 < 1e-2 and max-abs < 2e-2 of the scale per
    output; gemm_i8 bit-equal on the same int8 operands; rowquant's int8
    values within one step in under 0.1% of elements."""
    _need_card()
    for kern, plain in _width_cases(name, d):
        got, want = _tuple(kern()), _tuple(plain())
        torch.cuda.synchronize()
        for u, w in zip(got, want):
            if name == "gemm_i8":
                torch.testing.assert_close(u, w, atol=0, rtol=0)
            elif u.dtype == torch.int8:
                diff = (u.int() - w.int()).abs()
                assert diff.max() <= 1 and (diff > 0).float().mean() < 1e-3
            elif name == "rowquant":
                torch.testing.assert_close(u, w, atol=0, rtol=1e-6)
            else:
                assert _close(u.float(), w.float()), (name, d)


GEMM_I8_MODES = ("bf16", "f32_bias", "residual")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", GEMM_I8_MODES)
@pytest.mark.parametrize("n", [192, 576, 4096])
def test_gemm_i8_ragged_n_is_bit_exact_on_card(n, mode):
    """gemm_i8 on TMA + wgmma at N = 192 and 576 (a ragged last 256-wide
    column tile) and 4096, K = 1024, M = 1000 (a ragged last row block), in
    each epilogue mode: bit-equal to its plain version on the same int8
    operands (exact integer sums, the same float32 roundings), and two
    launches bit-equal (one writer per element)."""
    _need_card()
    gen = torch.Generator().manual_seed(n)
    m, k = 1000, 1024
    xq = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).cuda()
    wq = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8).cuda()
    rs = (torch.rand(m, 1, generator=gen) * 1e-2).cuda()
    cs = (torch.rand(1, n, generator=gen) * 1e-2).cuda()
    bias = torch.randn(n, generator=gen).cuda()
    res = torch.randn(m, n, generator=gen).cuda()
    kw = {"bf16": {}, "f32_bias": {"bias": bias, "out_dtype": torch.float32},
          "residual": {"bias": bias}}[mode]

    def run(fn):
        extra = {"residual": res.clone()} if mode == "residual" else {}
        return fn(xq, rs, wq, cs, **kw, **extra)

    got, again, want = run(q8.gemm_i8), run(q8.gemm_i8), run(q8.gemm_i8_plain)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert torch.equal(got, again)


DW_CASES = [("bf16", {}), ("f32_h_c", {"h32": True, "return_c": True}),
            ("f32_out", {"h32": True, "out_dtype": torch.float32})]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [c[0] for c in DW_CASES])
@pytest.mark.parametrize("hw", [16, 32])
@pytest.mark.parametrize("c", [256, 3072])
def test_dwconv_gelu_modes_match_plain_on_card(c, hw, mode):
    """dwconv_gelu's TMA body in each mode (bf16 h and out; float32 h with
    the float32 c; float32 h and out) at C = 256 and 3072 on a 16 x 16 and
    a 32 x 32 grid (float32 at hw 32 takes the row-band body): against its
    plain version (rel-L2 < 1e-2, max-abs < 2e-2 of the scale per output),
    and two launches bit-equal."""
    _need_card()
    gen = torch.Generator().manual_seed(c + hw)
    opts = dict(next(o for name, o in DW_CASES if name == mode))
    h32 = opts.pop("h32", False)
    b = 3
    h = torch.randn(b * hw * hw, c, generator=gen).to("cuda", torch.float32 if h32 else torch.bfloat16)
    dw = (torch.randn(9, c, generator=gen) / 3).to("cuda", torch.bfloat16)
    dwb = (torch.randn(c, generator=gen) * 0.1).cuda()
    got = _tuple(fs.dwconv_gelu(h, dw, dwb, hw, **opts))
    again = _tuple(fs.dwconv_gelu(h, dw, dwb, hw, **opts))
    want = _tuple(fs.dwconv_gelu_plain(h, dw, dwb, hw, **opts))
    torch.cuda.synchronize()
    for u, a, w in zip(got, again, want):
        assert u.dtype == w.dtype and _close(u.float(), w.float())
        assert torch.equal(u, a)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1280, 2048])
def test_ln_gemm_layernorm_past_1024_on_card(k):
    """ln_gemm's LayerNorm prologue on rows wider than the 1024 a warp holds
    in registers (embed_dim 1280 and 2048: each row read three times, in
    the register path's summation order), with the normalised rows out:
    against its plain version (rel-L2 < 1e-2, max-abs < 2e-2 of the
    scale), two launches bit-equal."""
    _need_card()
    a, w, _, lnp = _gemm_inputs(300, k, 3 * k // 2, True)
    want = fs.ln_gemm_plain(a, w, ln=lnp, return_xn=True)
    got = fs.ln_gemm(a, w, ln=lnp, return_xn=True)
    again = fs.ln_gemm(a, w, ln=lnp, return_xn=True)
    torch.cuda.synchronize()
    for u, v, x in zip(got, want, again):
        assert _close(u.float(), v.float())
        assert torch.equal(u, x)


# --------------- dwconv_gelu_bwd (TMA slab ring) and colsum (one launch) ---------------


def _dwb_inputs(b, hw, c, dtype, seed=0):
    """da float32 (the GELU output's gradient), c and h in `dtype`, bf16 taps."""
    gen = torch.Generator().manual_seed(seed + 31 * hw + c)
    m = b * hw * hw

    def r(*s, std=1.0, dt=torch.float32):
        return (torch.randn(*s, generator=gen) * std).to("cuda", dt)

    return r(m, c, std=1e-3), r(m, c, dt=dtype), r(m, c, dt=dtype), r(9, c, std=1 / 3,
                                                                     dt=torch.bfloat16)


# C = 96: three chunks, a number of units that 132 SMs do not divide (a
# partial last wave and chunks spread unevenly over the SMs); C = 3072: the
# flagship's; hw = 16 the whole grid, 20 ragged bands (float32) or the whole
# grid at its limit (bf16), 32 bands of 8
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("hw", [16, 20, 32])
@pytest.mark.parametrize("b,c", [(5, 96), (3, 3072)])
def test_dwconv_gelu_bwd_modes_match_plain_on_card(b, c, hw, dtype):
    """dwconv_gelu_bwd's TMA body in each mode (float32 or bf16 c and h; the
    whole grid or row bands) against its plain version: rel-L2 < 1e-2 and
    max-abs < 2e-2 of the scale for dhid, the taps, ddwb and db1; two
    launches bit-equal; one launch a call and no colsum after it."""
    _need_card()
    da, cc, h, dw = _dwb_inputs(b, hw, c, dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert lv.dwconv_gelu_bwd_plan(b, hw, c, dtype).units % sms  # a partial last wave
    before = dict(lv.LAUNCHES)
    got = lv.dwconv_gelu_bwd(da, cc, h, dw, hw)
    torch.cuda.synchronize()
    assert lv.LAUNCHES["dwconv_gelu_bwd"] == before["dwconv_gelu_bwd"] + 1
    assert lv.LAUNCHES["colsum"] == before["colsum"]
    again = lv.dwconv_gelu_bwd(da, cc, h, dw, hw)
    want = lv.dwconv_gelu_bwd_plain(da, cc, h, dw, hw)
    torch.cuda.synchronize()
    for u, a, w in zip(got, again, want):
        assert u.dtype == w.dtype and u.shape == w.shape
        assert _close(u.float(), w.float())
        assert torch.equal(u, a)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 31, 1025, 32768])
@pytest.mark.parametrize("c", [768, 1536, 100, 33])
def test_colsum_shapes_match_plain_on_card(r, c):
    """colsum in one launch at R = 1, 31, 1025 and 32768 (db2 at batch 128)
    and at C = 768, 1536 (layernorm_bwd's partials), 100 and 33 (not
    multiples of 32; 33 takes 4-byte loads): against `colsum_plain`
    (rel-L2 < 1e-2, max-abs < 2e-2 of the scale) and two launches
    bit-equal."""
    _need_card()
    gen = torch.Generator().manual_seed(r + c)
    x = torch.randn(r, c, generator=gen).cuda()
    before = lv.LAUNCHES["colsum"]
    got = lv.colsum(x)
    torch.cuda.synchronize()
    assert lv.LAUNCHES["colsum"] == before + 1
    again = lv.colsum(x)
    want = lv.colsum_plain(x)
    torch.cuda.synchronize()
    assert got.shape == (c,) and _close(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_backward_colsum_launches_drop_on_card():
    """The launches that the in-kernel sums take away: a K2 layer's backward
    runs 4 colsum launches (db2 and the three layernorm_bwd partials, each
    one launch) and one dwconv_gelu_bwd; K5's backward 8 launches in all
    (ln_gemm 3, dwconv_gelu 1, weight_grad 2, colsum 1 for db2 at 2048
    rows, dwconv_gelu_bwd 1)."""
    _need_card()
    x, cond, g, params = _layer_args(2, 16, seed=9)
    x.requires_grad_(True)
    lv.reset_launch_counts()
    lv.fused_layer(x, cond, params, 2, 16).backward(g)
    torch.cuda.synchronize()
    assert lv.LAUNCHES["colsum"] == 4 and lv.LAUNCHES["dwconv_gelu_bwd"] == 1
    args = _port_mlp_args(*_mlp_inputs(32, d=128), torch.bfloat16, "cuda")
    xm, w1, b1, dw, dwb, w2, _ = args
    gm = torch.randn(xm.shape, device="cuda").to(torch.bfloat16)
    lv.reset_launch_counts()
    fs.reset_launch_counts()
    fm.fused_mlp_sepconv_bwd(xm, gm, w1, b1, dw, dwb, w2, 32)
    torch.cuda.synchronize()
    counts = {**{k: v for k, v in fs.LAUNCHES.items() if v},
              **{k: v for k, v in lv.LAUNCHES.items() if v}}
    assert counts == {"ln_gemm": 3, "dwconv_gelu": 1, "weight_grad": 2, "colsum": 1,
                      "dwconv_gelu_bwd": 1}


# ------------------------------ the sampler's CUDA graph ------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(sampler="ddim"), dict(sampler="dpm", cache_interval=2),
                                dict(sampler="ddim", eta=0.5), dict(sampler="heun")],
                         ids=["ddim", "dpm_cached", "eta", "heun"])
def test_sampler_graph_replay_matches_eager_on_card(kw):
    """A tiny bf16 engine (4 layers, d = 128, 8 x 8 tokens): a key's first
    call runs eagerly, its second captures and replays, a third with
    another seed and guidance replays (no new capture); each is bit-equal
    to `sample_loop` run eagerly on its inputs, and the kernels' counts
    are the eager run's (the capture's taken back, a replay's added)."""
    _need_card()
    from transformer_latent_diffusion_tpu_torch.configs import DenoiserConfig
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import make_fused_apply
    from transformer_latent_diffusion_tpu_torch.sampling.diffusion import DiffusionGenerator
    from transformer_latent_diffusion_tpu_torch.utils.common import init_random_weights_

    cfg = DenoiserConfig(image_size=16, embed_dim=128, n_layers=4, noise_embed_dims=64)
    model = init_random_weights_(Denoiser.from_config(cfg, dtype=torch.bfloat16), 0)
    model.to("cuda").eval()
    gen = DiffusionGenerator(model, fast_apply=make_fused_apply(cfg), device="cuda")
    labels = torch.randn(2, cfg.text_emb_size, generator=torch.Generator().manual_seed(2))
    call = dict(n_iter=5, num_imgs=2, img_size=16, sharp_f=0, bright_f=0, **kw)
    for n, (seed, g) in enumerate(((3, 4.0), (7, 6.5), (9, 2.0))):
        plan = gen.plan_loop(labels, seed=seed, class_guidance=g,
                             **{k: v for k, v in call.items() if k not in ("sharp_f", "bright_f")})
        fs.reset_launch_counts()
        eager = plan.run_eager()
        torch.cuda.synchronize()
        want_launches = dict(fs.LAUNCHES)
        fs.reset_launch_counts()
        _, got = gen.generate(labels, seed=seed, class_guidance=g, **call)
        torch.cuda.synchronize()
        assert (gen.graphs.captures, gen.graphs.replays) == (min(n, 1), n)
        assert torch.equal(got, eager)
        assert dict(fs.LAUNCHES) == want_launches


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_inpaint_graph_keeps_the_region_on_card(sampler):
    """Inpainting through the engine and the sampler's graph on a tiny
    bf16 model (2 layers, d = 128, 8 x 8 tokens), a half mask and other
    init latents at each call: the eager first call, the capture and a
    replay are each bit-equal to `sample_loop` run eagerly on their inputs
    and keep the unmasked region bit-equal to init (with sharp/bright
    shifts); a widened model's context goes through the same route."""
    _need_card()
    from transformer_latent_diffusion_tpu_torch.configs import DenoiserConfig
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import make_fused_apply
    from transformer_latent_diffusion_tpu_torch.sampling.diffusion import DiffusionGenerator
    from transformer_latent_diffusion_tpu_torch.utils.common import init_random_weights_

    g = torch.Generator().manual_seed(5)
    labels = torch.randn(2, 768, generator=g)
    mask = torch.zeros(1, 1, 16, 16)
    mask[..., :8, :] = 1.0
    for input_channels in (None, 8):
        cfg = DenoiserConfig(image_size=16, embed_dim=128, n_layers=2, noise_embed_dims=64,
                             input_channels=input_channels)
        model = init_random_weights_(Denoiser.from_config(cfg, dtype=torch.bfloat16), 0)
        gen = DiffusionGenerator(model.to("cuda").eval(), fast_apply=make_fused_apply(cfg),
                                 device="cuda")
        for n in range(3):
            init = torch.randn(2, 4, 16, 16, generator=g)
            call = dict(n_iter=5, num_imgs=2, img_size=16, seed=n, sampler=sampler,
                        init_latents=init, mask=mask, strength=0.8)
            if input_channels:
                call["context_latents"] = torch.randn(2, 4, 16, 16, generator=g)
            eager = gen.plan_loop(labels, **call).run_eager()
            _, got = gen.generate(labels, sharp_f=0.1, bright_f=0.1, **call)
            torch.cuda.synchronize()
            assert (gen.graphs.captures, gen.graphs.replays) == (min(n, 1), n)
            assert torch.equal(got[..., 8:, :], init.cuda()[..., 8:, :])
            eager[:, 3] += 0.1 * mask.cuda()[:, 0]
            eager[:, 0] += 0.1 * mask.cuda()[:, 0]
            assert torch.equal(got, eager)


# ------------------------------ K1 and K7 with float32 weights ------------------------------


def _f32_cases(dev):
    """(name, kernel call, plain call, float32 body) at small shapes, a
    residual-updating call compared through its update: the four float32
    bodies, ln_gemm in each mode, the ragged tiles (N = 200 tokens, 144
    columns, 72 rows)."""
    g = torch.Generator().manual_seed(7)
    b, hw, d, heads = 2, 8, 192, 3
    n, m = hw * hw, 2 * hw * hw

    def r(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    x, ln = r(m, d), (1 + r(d, std=0.1), r(d, std=0.1))
    w, w1, b1 = r(3 * d, d, std=d ** -0.5), r(4 * d, d, std=d ** -0.5), r(4 * d)
    w2, b2, act = r(d, 4 * d, std=(4 * d) ** -0.5), r(d), r(m, 4 * d)
    qkv, qc, kv = r(m, 3 * d), r(m, d), r(2 * b, 2 * d)
    qkv200, x200 = r(2 * 200, 3 * d), r(2 * 200, d)
    hmat, dw, dwb = r(m, 4 * d), r(9, 4 * d, std=1 / 3), r(4 * d)
    wr = r(144, d, std=d ** -0.5)
    return [
        ("ln_gemm ln", lambda: fs.ln_gemm(x, w, ln=ln), lambda: fs.ln_gemm_plain(x, w, ln=ln),
         "ln_gemm_f32"),
        ("ln_gemm bias", lambda: fs.ln_gemm(act, w2, bias=b2),
         lambda: fs.ln_gemm_plain(act, w2, bias=b2), "ln_gemm_f32"),
        ("ln_gemm residual", lambda: fs.ln_gemm(act, w2, bias=b2, residual=x.clone()) - x,
         lambda: fs.ln_gemm_plain(act, w2, bias=b2, residual=x) - x, "ln_gemm_f32"),
        ("ln_gemm ragged", lambda: fs.ln_gemm(x[:72].contiguous(), wr, bias=b1[:144].contiguous()),
         lambda: fs.ln_gemm_plain(x[:72], wr, bias=b1[:144]), "ln_gemm_f32"),
        ("ln_gemm expand", lambda: fs.ln_gemm(x, w1, bias=b1),
         lambda: fs.ln_gemm_plain(x, w1, bias=b1), "ln_gemm_f32"),
        ("self_attention", lambda: fs.self_attention(qkv, x.clone(), heads, n) - x,
         lambda: fs.self_attention_plain(qkv, x, heads, n) - x, "self_attention_f32"),
        ("self_attention N=200", lambda: fs.self_attention(qkv200, x200.clone(), heads, 200) - x200,
         lambda: fs.self_attention_plain(qkv200, x200, heads, 200) - x200,
         "self_attention_f32"),
        ("cross_attention", lambda: _cat_update(fs.cross_attention(qc, kv, x.clone(), ln, heads, n), x),
         lambda: _cat_update(fs.cross_attention_plain(qc, kv, x, ln, heads, n), x),
         "cross_attention_f32"),
        ("cross_attention ln=None", lambda: fs.cross_attention(qc, kv, x.clone(), None, heads, n)[0] - x,
         lambda: fs.cross_attention_plain(qc, kv, x, None, heads, n)[0] - x,
         "cross_attention_f32"),
        ("dwconv_gelu", lambda: fs.dwconv_gelu(hmat, dw, dwb, hw),
         lambda: fs.dwconv_gelu_plain(hmat, dw, dwb, hw), "dwconv_gelu_f32"),
    ]


def _cat_update(outs, x):
    return torch.cat([(outs[0] - x).flatten(), outs[1].flatten()])


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(10))
def test_float32_body_matches_plain_on_card(case):
    """Each float32 body against its plain version on the card, TF32 off:
    both sum float32 products in float32, in other orders, so rel-L2 within
    1e-5; one launch counted in fused_stack_f32.LAUNCHES and none in the
    bf16 counts; two launches bit-equal."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    name, kern, plain, body = _f32_cases("cuda")[case]
    want = plain()
    before, bf16_before = dict(f32.LAUNCHES), dict(fs.LAUNCHES)
    got = kern()
    torch.cuda.synchronize()
    assert f32.LAUNCHES[body] == before[body] + 1 and dict(fs.LAUNCHES) == bf16_before
    assert got.dtype == torch.float32
    assert _rel_l2(got, want) <= 1e-5, name
    assert torch.equal(got, kern()), name


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_float32_stack_matches_plain_on_card(quantize):
    """Two float32 layers of K1 (rel-L2 of the update within 1e-4) and of
    K7 (within the [int8] bound of chip_smoke.py, 0.04: its rowquant flips)
    against the plain stacks, at d = 192 on an 8 x 8 grid, with the float32
    bodies' launches per layer."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(9)
    d, hw, b = 192, 8, 4
    params = {}
    for i in range(2):
        pre = f"denoiser_trans_block.decoder_blocks.{i}"
        for name, shape in (("norm1.weight", (d,)), ("norm1.bias", (d,)),
                            ("norm2.weight", (d,)), ("norm2.bias", (d,)),
                            ("norm3.weight", (d,)), ("norm3.bias", (d,)),
                            ("self_attention.qkv_linear.weight", (3 * d, d)),
                            ("cross_attention.q_linear.weight", (d, d)),
                            ("cross_attention.kv_linear.weight", (2 * d, d)),
                            ("mlp.mlp.0.weight", (4 * d, d, 1, 1)), ("mlp.mlp.0.bias", (4 * d,)),
                            ("mlp.mlp.1.weight", (4 * d, 1, 3, 3)), ("mlp.mlp.1.bias", (4 * d,)),
                            ("mlp.mlp.3.weight", (d, 4 * d, 1, 1)), ("mlp.mlp.3.bias", (d,))):
            fan = shape[1] if len(shape) > 1 and shape[1] > 1 else 9
            params[f"{pre}.{name}"] = (torch.randn(*shape, generator=g) * fan ** -0.5
                                       + (1.0 if name.startswith("norm") and "weight" in name
                                          else 0.0)).cuda()
    x = torch.randn(b, hw * hw, d, generator=g).cuda()
    cond = torch.randn(b, 2, d, generator=g).cuda()
    pack, run, plain_run = ((fs.pack_layer_stack, fs.fused_layer_stack,
                             fs.fused_layer_stack_plain) if quantize is None else
                            (q8.pack_layer_stack_int8, q8.fused_layer_stack_int8,
                             q8.fused_layer_stack_int8_plain))
    stack = pack(params, [0, 1], torch.float32)
    f32.reset_launch_counts()
    got = run(x, cond, stack, hw, 3)
    torch.cuda.synchronize()
    want = plain_run(x, cond, stack, hw, 3)
    per_layer = f32.launches_per_layer(torch.float32, quantize)
    assert f32.LAUNCHES == {k: 2 * per_layer.get(k, 0) for k in f32.KERNELS}
    assert _rel_l2(got - x, want - x) <= (1e-4 if quantize is None else 0.04)

