"""The port's attention-pair kernels against the JAX package's on the CPU:
K6 (`ops/fused_attn_vjp.py`, forward and all nine gradients) against the
JAX `fused_attention_pair_vjp` in interpret mode, K8 and K9
(`ops/fused_block.py`) against the JAX `fused_block` kernels in interpret
mode, the kernel routes' composition (their wrappers take the plain
versions on CPU tensors) against the plain versions, and the decoder
block that routes to K6 (the JAX block's gates; a bf16 block of 200
tokens against the JAX block). Mirrors tests/test_fused_attn_vjp.py at
its sizes (B = 2, N = 16, D = 64, 2 heads)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.models.blocks import MLP as JaxMLP
from transformer_latent_diffusion_tpu.models.blocks import DecoderBlock as JaxDecoderBlock
from transformer_latent_diffusion_tpu.models.moe import MoEMLP as JaxMoEMLP
from transformer_latent_diffusion_tpu.ops import fused_block as jfb
from transformer_latent_diffusion_tpu.ops.fused_attn_vjp import fused_attention_pair_vjp as jk6
from transformer_latent_diffusion_tpu.utils.goldens import rel_l2
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models import blocks
from transformer_latent_diffusion_tpu_torch.ops import fused_attn_vjp as k6
from transformer_latent_diffusion_tpu_torch.ops import fused_block as fb
from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

torch.set_num_threads(2)

B, N, D, H = 2, 16, 64, 2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NAMES = ("x", "cond") + k6.PARAM_NAMES
# the projections and activations in the compute dtype; LayerNorm float32
LOWP = ("x", "cond", "wqkv", "wq", "wkv")


def _np(t):
    return t.detach().float().numpy()


def _k6_args(seed=0):
    """The nine K6 inputs in the JAX layouts (projections (in, out)), as
    tests/test_fused_attn_vjp.py draws them (LayerNorm scales near 1)."""
    rng = np.random.default_rng(seed)

    def arr(*s, scale=0.3):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return [arr(B, N, D), arr(B, 2, D), 1 + arr(D, scale=0.1), arr(D),
            arr(D, 3 * D), 1 + arr(D, scale=0.1), arr(D), arr(D, D), arr(D, 2 * D)]


def _jax_in(args, dtype):
    return [jnp.asarray(a, dtype if n in LOWP else jnp.float32)
            for n, a in zip(NAMES, args)]


def _port_in(args, dtype, requires_grad=False):
    """The same inputs in the port's layouts: projections (out, in)."""
    out = []
    for n, a in zip(NAMES, args):
        a = a.T.copy() if n in ("wqkv", "wq", "wkv") else a
        t = torch.from_numpy(a).to(dtype if n in LOWP else torch.float32)
        out.append(t.requires_grad_(requires_grad))
    return out


def _to_jax_layout(name, g):
    g = _np(g)
    return g.T if name in ("wqkv", "wq", "wkv") else g


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k6_forward_matches_jax_kernel(dtype):
    """The plain K6 forward against the JAX kernel (interpret mode): in
    float32 within atol 2e-5, rtol 1e-4 (the JAX test holds its kernel to
    atol 2e-4, rtol 1e-3); in bf16 the output within rel-L2 2e-3 (one-step
    flips of the bf16 roundings of qkv, qc, kv and p)."""
    jdt, tdt = DTYPES[dtype]
    args = _k6_args(0)
    want = np.asarray(jk6(*_jax_in(args, jdt), H, True), np.float32)
    got = _np(k6.fused_attention_pair_vjp(*_port_in(args, tdt), H))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    else:
        assert rel_l2(got, want) < 2e-3


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k6_gradients_match_jax_kernel(dtype):
    """All nine gradients (dx, dcond, dLN1, dWqkv, dLN2, dWq, dWkv) of the
    plain K6 backward against the JAX kernel's (interpret mode) for one
    upstream gradient: in float32 each within atol 5e-6, rtol 1e-4 (the
    JAX test: atol 5e-4, rtol 5e-3); in bf16, where the projections'
    gradients are rounded to bf16 as the TPU kernel's `_vjp_bwd` casts
    them, each within rel-L2 1e-2."""
    jdt, tdt = DTYPES[dtype]
    args = _k6_args(1)
    g = (np.random.default_rng(2).standard_normal((B, N, D)) * 0.1).astype(np.float32)
    jin = _jax_in(args, jdt)
    _, vjp = jax.vjp(lambda *a: jk6(*a, H, True), *jin)
    want = vjp(jnp.asarray(g, jdt))
    tin = _port_in(args, tdt, requires_grad=True)
    out = k6.fused_attention_pair_vjp(*tin, H)
    out.backward(torch.from_numpy(g).to(tdt))
    for name, t, w in zip(NAMES, tin, want):
        assert t.grad.dtype == t.dtype, name
        got, w = _to_jax_layout(name, t.grad), np.asarray(w, np.float32)
        assert got.shape == w.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(got, w, atol=5e-6, rtol=1e-4, err_msg=name)
        else:
            assert rel_l2(got, w) < 1e-2, name


def test_k6_kernel_route_matches_plain():
    """The kernel route's composition (`_attn_pair_forward` and
    `_attn_pair_bwd` over the wrappers, which take the plain versions on
    CPU tensors) against the written-out plain forward and backward, in
    bf16 as on the card: the output and all nine gradients within rel-L2
    1e-2."""
    args = _port_in(_k6_args(3), torch.bfloat16)
    x, cond, params = args[0], args[1], tuple(args[2:])
    g = torch.randn(B, N, D, generator=torch.Generator().manual_seed(4)) * 0.1
    r = lv._attn_pair_forward(x, cond, params, H, keep=False)
    want = k6.fused_attention_pair_fwd_plain(x, cond, *params, H)
    assert rel_l2(_np(r["x2"].reshape(B, N, D) - x.float()),
                  _np(want.float() - x.float())) < 1e-2
    r = lv._attn_pair_forward(x, cond, params, H, keep=True)
    dx, dcond, grads = lv._attn_pair_bwd(r, g.reshape(B * N, D), params, H, N)
    got = [dx.reshape(B, N, D), dcond.reshape(B, 2, D), *grads]
    want = k6.fused_attention_pair_bwd_plain(x, cond, g.to(torch.bfloat16), *params, H)
    for name, u, w in zip(NAMES, got, want):
        assert rel_l2(_np(u), _np(w)) < 1e-2, name


def test_k6_wrappers_refuse_other_devices():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing; on any other device (meta: no card needed) they refuse."""
    args = _port_in(_k6_args(5), torch.bfloat16)
    fs.reset_launch_counts(), lv.reset_launch_counts(), k6.reset_launch_counts()
    k6.fused_attention_pair_vjp(*args, H)
    assert not any(fs.LAUNCHES.values()) and not any(k6.LAUNCHES.values())
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        k6.fused_attention_pair_fwd(*meta, H)
    with pytest.raises(ValueError, match="CUDA"):
        k6.fused_attention_pair_bwd(meta[0], meta[1], meta[0], *meta[2:], H)


# ------------------------------ K8 and K9 ------------------------------


def _k8_args(seed, n=N):
    rng = np.random.default_rng(seed)

    def arr(*s, scale=0.3):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return [arr(B, n, D), 1 + arr(D, scale=0.1), arr(D), arr(D, 3 * D),
            1 + arr(D, scale=0.1), arr(D), arr(D, D), arr(B, 2, D, scale=1),
            arr(B, 2, D, scale=1)]


def _k9_args(seed, hw=4, hidden=4 * D):
    rng = np.random.default_rng(seed)

    def arr(*s, scale=0.3):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return [arr(B, hw * hw, D), 1 + arr(D, scale=0.1), arr(D), arr(D, hidden),
            arr(hidden, scale=0.1), arr(3, 3, hidden), arr(hidden, scale=0.1),
            arr(hidden, D, scale=0.1), arr(D, scale=0.1)]


def _cast(args, lowp, jdt, tdt, transpose=()):
    jax_args = [jnp.asarray(a, jdt if i in lowp else jnp.float32)
                for i, a in enumerate(args)]
    port = []
    for i, a in enumerate(args):
        a = a.T.copy() if i in transpose else a
        port.append(torch.from_numpy(np.ascontiguousarray(a)).to(
            tdt if i in lowp else torch.float32))
    return jax_args, port


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k8_plain_matches_jax_kernel(dtype):
    """K8 (`fused_attention_pair`, cond K/V given) against the JAX kernel in
    interpret mode: float32 within atol 2e-5, rtol 1e-4; bf16 within
    rel-L2 2e-3 of the layer's update."""
    jdt, tdt = DTYPES[dtype]
    args = _k8_args(6)
    jargs, targs = _cast(args, (0, 3, 6, 7, 8), jdt, tdt, transpose=(3, 6))
    want = np.asarray(jfb.fused_attention_pair(*jargs, H, interpret=True), np.float32)
    got = _np(fb.fused_attention_pair(*targs, H))
    x = np.asarray(jargs[0], np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    else:
        assert rel_l2(got - x, want - x) < 2e-3


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k9_plain_matches_jax_kernel(dtype):
    """K9 (`fused_mlp_sepconv`: LN3, expand, 3x3 depthwise, GELU, contract,
    residual) against the JAX kernel in interpret mode, the depthwise taps
    as (9, hidden): float32 within atol 2e-5, rtol 1e-4 (the exact erf
    against `_erf_poly`, |err| < 1.5e-7, and sums in another order); bf16
    within rel-L2 2e-3 of the update."""
    jdt, tdt = DTYPES[dtype]
    args = _k9_args(7)
    jargs, targs = _cast(args, (0, 3, 5, 7), jdt, tdt, transpose=(3, 7))
    targs[5] = targs[5].reshape(9, -1)
    want = np.asarray(jfb.fused_mlp_sepconv(*jargs, 4, interpret=True), np.float32)
    got = _np(fb.fused_mlp_sepconv(*targs, 4))
    x = np.asarray(jargs[0], np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    else:
        assert rel_l2(got - x, want - x) < 2e-3


def test_k8_k9_kernel_routes_match_plain():
    """K8's and K9's kernel routes (K1's wrappers, which take the plain
    versions on CPU tensors) against their plain versions in bf16: K8 is
    the same composition (equal), K9's route adds the contract bias after
    the residual (within 1e-6 of the float32 update before the bf16
    output rounding, so at most one bf16 step)."""
    _, t8 = _cast(_k8_args(8), (0, 3, 6, 7, 8), jnp.bfloat16, torch.bfloat16, (3, 6))
    torch.testing.assert_close(fb._attention_pair(*t8, H, fb._KERNEL_OPS),
                               fb.fused_attention_pair_plain(*t8, H), atol=0, rtol=0)
    _, t9 = _cast(_k9_args(9), (0, 3, 5, 7), jnp.bfloat16, torch.bfloat16, (3, 7))
    t9[5] = t9[5].reshape(9, -1)
    res, a = fb._mlp_hidden(*t9[:7], 4, fb._KERNEL_OPS)
    route = fs.ln_gemm(a, t9[7], bias=t9[8], residual=res.clone())
    plain = res + fs.ln_gemm_plain(a, t9[7], bias=t9[8], out_dtype=torch.float32)
    torch.testing.assert_close(route, plain, atol=1e-6, rtol=0)
    got = _np(fb.fused_mlp_sepconv(*t9, 4))
    want = _np(fb.fused_mlp_sepconv_plain(*t9, 4))
    assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max()
    meta = [t.to("meta") for t in t9]
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_mlp_sepconv(*meta, 4)
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_attention_pair(*[t.to("meta") for t in t8], H)


# ------------------------------ the block's route to K6 ------------------------------


JAX_FFN = {"mlp": JaxMLP, "moe": JaxMoEMLP}


@pytest.mark.parametrize("mlp_class,fused_layer,fused_attn,n,want", [
    ("sep_conv", True, False, 16, "k2"), ("sep_conv", False, True, 16, "k6"),
    ("mlp", True, False, 16, "k6"), ("moe", True, False, 200, "k6"),
    ("mlp", True, False, 324, "plain"), ("mlp", False, False, 16, "plain"),
])
def test_block_gates_follow_jax(monkeypatch, mlp_class, fused_layer, fused_attn, n, want):
    """The JAX block's gates (models/blocks.py:269-284): K2 for the
    sep-conv FFN on a square grid of at most 256 tokens; K6 for
    fused_attn_vjp, or a fused-layer block K2 does not take (another FFN,
    or a grid that is not square), of at most 256 tokens; the plain
    attention modules otherwise."""
    calls = []
    monkeypatch.setattr(blocks, "fused_attention_pair_vjp",
                        lambda *a: calls.append("k6") or k6.fused_attention_pair_vjp(*a))
    monkeypatch.setattr(blocks.DecoderBlock, "_fused",
                        lambda self, x, y, hw: calls.append("k2") or x)
    block = blocks.DecoderBlock(D, 2, fused_layer_vjp=fused_layer,
                                fused_attn_vjp=fused_attn, mlp_class=mlp_class,
                                n_experts=2)
    block(torch.randn(1, n, D), torch.randn(1, 2, D))
    assert calls == ([] if want == "plain" else [want])


def _jax_block(mlp_class, dtype=jnp.float32):
    return JaxDecoderBlock(embed_dim=D, mlp_multiplier=2, dropout_level=0.0,
                           fused_layer_vjp=True, mlp_class=JAX_FFN[mlp_class],
                           n_experts=2, dtype=dtype)


def _block_grads(block, fwd, params, x, y, g):
    """Output and the gradients of sum(out * g) for x, y and the params."""
    if block is None:  # the port's block, `fwd` is the module
        xt = torch.from_numpy(x).to(fwd.dtype).requires_grad_(True)
        yt = torch.from_numpy(y).to(fwd.dtype).requires_grad_(True)
        out = fwd(xt, yt)
        (out.float() * torch.from_numpy(g)).sum().backward()
        grads = {"x": _np(xt.grad), "cond": _np(yt.grad)}
        grads.update({n: _np(p.grad) for n, p in fwd.named_parameters()})
        return _np(out), grads

    def f(p, xx, yy):
        out = block.apply({"params": p}, xx, yy)
        return jnp.sum(out.astype(jnp.float32) * g), out

    # eager, op by op, so each operation rounds where its dtype says
    (_, out), (gp, gx, gy) = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x, block.dtype), jnp.asarray(y, block.dtype))
    grads = {"x": np.asarray(gx, np.float32), "cond": np.asarray(gy, np.float32)}
    grads.update({k: v.numpy() for k, v in _state_dict(gp).items()})
    return np.asarray(out, np.float32), grads


def _state_dict(params):
    return {k: torch.from_numpy(v) for k, v in
            convert.decoder_block_state_dict(jax.tree.map(np.asarray, params)).items()}


def _case(mlp_class, n, seed, batch=B):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n, D)).astype(np.float32)
    y = rng.standard_normal((batch, 2, D)).astype(np.float32)
    g = (rng.standard_normal((batch, n, D)) * 0.1).astype(np.float32)
    params = _jax_block(mlp_class).init(jax.random.PRNGKey(seed), jnp.asarray(x),
                                        jnp.asarray(y))["params"]
    return params, x, y, g


def test_fused_block_of_200_tokens_matches_jax_block():
    """A bf16 DecoderBlock(fused_layer_vjp=True) with the plain MLP on 200
    tokens, a grid that is not square, where the JAX block runs K6 (in
    interpret mode on the CPU): the port now runs K6's plain version there
    too. Against the JAX block, by rel-L2: the block's update below 0.004,
    the gradients of x, cond and the weight matrices below 0.006, those of
    the LayerNorm and bias vectors (sums of bf16 products in another
    order) below 0.02.

    Measured (batch 1): the update 0.00270 through K6's route, 0.00612
    through the plain attention modules the port ran there before (the
    linen route, rounding at other points, computed here too); the
    matrices' gradients up to 0.00516 through K6 (up to 0.0073 through the
    linen route at batch 2)."""
    params, x, y, g = _case("mlp", 200, 10, batch=1)
    jout, jgrads = _block_grads(_jax_block("mlp", jnp.bfloat16), None, params, x, y, g)
    block = blocks.DecoderBlock(D, 2, dtype=torch.bfloat16, fused_layer_vjp=True,
                                mlp_class="mlp")
    block.load_state_dict(_state_dict(params))
    out, grads = _block_grads(None, block, params, x, y, g)
    linen = blocks.DecoderBlock(D, 2, dtype=torch.bfloat16, mlp_class="mlp")
    linen.load_state_dict(_state_dict(params))
    with torch.no_grad():
        before = rel_l2(_np(linen(torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(y).bfloat16())) - x, jout - x)
    errs = {k: rel_l2(v, jgrads[k]) for k, v in grads.items()}
    after = rel_l2(out - x, jout - x)
    print(f"bf16 block, 200 tokens, port vs JAX rel-L2 of the update: K6 route "
          f"{after:.5f}, linen route {before:.5f}; gradients {errs}")
    assert after < 0.004 < before
    mats = {k: v for k, v in errs.items() if grads[k].ndim > 1}
    vecs = {k: v for k, v in errs.items() if k not in mats}
    assert max(mats.values()) < 0.006, mats
    assert max(vecs.values()) < 0.02, vecs


# ------------------------------ K6's bf16 route ------------------------------

# the route's kernels take head dim 64: D = 128, 2 heads; N = 16, a ragged
# N whose 128-row tiles span many batch elements (13 tokens, 10 elements:
# 130 rows), and N = 144, where a tile spans two elements as on the card
RD, RH = 128, 2
ROUTE_CASES = {"n16": (2, 16), "n13": (10, 13), "n144": (2, 144)}
ROUTE_PLAIN = ("pair_qkv_plain", "self_attention_x1_plain", "pair_cross_fwd_plain",
               "pair_cross_bwd_plain", "pair_dkv_plain", "pair_ln_bwd_plain")


def _route_args(seed, b, n):
    """The nine K6 inputs at width RD in the JAX layouts."""
    rng = np.random.default_rng(seed)

    def arr(*s, scale=0.2):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return [arr(b, n, RD, scale=0.5), arr(b, 2, RD, scale=0.5), 1 + arr(RD, scale=0.1),
            arr(RD, scale=0.1), arr(RD, 3 * RD), 1 + arr(RD, scale=0.1), arr(RD, scale=0.1),
            arr(RD, RD), arr(RD, 2 * RD)]


def _route_in(args, requires_grad=False):
    """The inputs in the port's layouts and dtypes (bf16 activations and
    projections, float32 LayerNorm)."""
    out = []
    for name, a in zip(NAMES, args):
        a = a.T.copy() if name in ("wqkv", "wq", "wkv") else a
        t = torch.from_numpy(a).to(torch.bfloat16 if name in LOWP else torch.float32)
        out.append(t.requires_grad_(requires_grad))
    return out


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_k6_bf16_route_matches_jax_kernel(case):
    """The bf16 route on CPU tensors (each kernel's plain version, in the
    kernels' layouts: row tiles, per-element partials) against the JAX K6
    in interpret mode, through the autograd function: the output within
    rel-L2 2e-3 of the update and each of the nine gradients within 1e-2
    (one-step flips of the bf16 roundings, sums in another order).

    Measured: the update 1.3e-3 to 1.6e-3, the gradients at most 5.7e-3."""
    b, n = ROUTE_CASES[case]
    args = _route_args(11, b, n)
    g = (np.random.default_rng(12).standard_normal((b, n, RD)) * 0.1).astype(np.float32)
    jin = _jax_in(args, jnp.bfloat16)
    jout, vjp = jax.vjp(lambda *a: jk6(*a, RH, True), *jin)
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    tin = _route_in(args, requires_grad=True)
    out = k6.fused_attention_pair_vjp(*tin, RH)
    x = args[0]
    fwd = rel_l2(_np(out) - x, np.asarray(jout, np.float32) - x)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    errs = {name: rel_l2(_to_jax_layout(name, t.grad), np.asarray(w, np.float32))
            for name, t, w in zip(NAMES, tin, want)}
    print(f"{case}: update {fwd:.2e}, gradients {errs}")
    assert fwd < 2e-3
    assert max(errs.values()) < 1e-2, errs


def test_k6_route_on_cpu_takes_the_plain_versions(monkeypatch):
    """On CPU tensors in bf16 the entry points run the route with each
    kernel's plain version, in the route's order, and launch nothing; the
    results equal `route_fwd` / `route_bwd` run directly."""
    b, n = ROUTE_CASES["n144"]
    tin = _route_in(_route_args(13, b, n))
    x, cond, params = tin[0], tin[1], tin[2:]
    g = torch.randn(b, n, RD, generator=torch.Generator().manual_seed(14)).to(torch.bfloat16)
    calls = []
    for name in ROUTE_PLAIN:
        real = getattr(k6, name)
        monkeypatch.setattr(k6, name, lambda *a, _f=real, _n=name: calls.append(_n) or _f(*a))
    fs.reset_launch_counts(), lv.reset_launch_counts(), k6.reset_launch_counts()
    out = k6.fused_attention_pair_fwd(x, cond, *params, RH)
    assert calls == ["pair_qkv_plain", "self_attention_x1_plain", "pair_cross_fwd_plain"]
    calls.clear()
    grads = k6.fused_attention_pair_bwd(x, cond, g, *params, RH)
    # pair_cross_bwd_plain takes LN2 -> Q through pair_qkv_plain
    assert calls == ["pair_qkv_plain", "self_attention_x1_plain", "pair_cross_bwd_plain",
                     "pair_qkv_plain", "pair_dkv_plain", "pair_ln_bwd_plain",
                     "pair_ln_bwd_plain"]
    assert not any(fs.LAUNCHES.values()) and not any(lv.LAUNCHES.values())
    assert not any(k6.LAUNCHES.values())
    assert torch.equal(out, k6.route_fwd(x, cond, params, RH))
    dx, dcond, rest = k6.route_bwd(x, cond, g, params, RH)
    assert out.dtype == grads[0].dtype == grads[1].dtype == torch.bfloat16
    for u, w in zip(grads, (dx, dcond, *rest)):
        assert torch.equal(u, w.reshape(u.shape))


def _route_stage_inputs(seed):
    """The route's intermediate tensors at the "n13" case, each from the
    plain versions: (x rows, cond rows, g rows, params, qkv, stats1, x1,
    kv)."""
    b, n = ROUTE_CASES["n13"]
    tin = _route_in(_route_args(seed, b, n))
    x, cond, params = tin[0].reshape(b * n, RD), tin[1].reshape(2 * b, RD), tin[2:]
    g = (torch.randn(b * n, RD, generator=torch.Generator().manual_seed(seed)) * 0.1).to(
        torch.bfloat16)
    ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv = params
    qkv, _, stats1 = k6.pair_qkv_plain(x, ln1s, ln1b, wqkv)
    x1 = k6.self_attention_x1_plain(qkv, x, RH, n)
    kv = fs.ln_gemm_plain(cond, wkv)
    return x, cond, g, params, qkv, stats1, x1, kv


@pytest.mark.parametrize("name", ["pair_qkv", "self_attention_x1", "pair_cross_fwd",
                                  "pair_cross_bwd", "pair_ln_bwd"])
def test_route_kernel_plain_matches_k2_helpers(name):
    """Each route kernel's plain version against the plain versions of the
    K1 / K2 kernels it replaces, at 13 tokens (row tiles spanning ten
    batch elements): the same roundings, so bit-equal or within float32
    sum order; the tiles' partial sums (dkv, dscale, dbias) add up to the
    whole sums within 1e-5 relative (bf16 dkv: one rounding step)."""
    b, n = ROUTE_CASES["n13"]
    x, cond, g, params, qkv, stats1, x1, kv = _route_stage_inputs(15)
    ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv = params
    if name == "pair_qkv":
        got_qkv, got_xn, got_stats = k6.pair_qkv_plain(x, ln1s, ln1b, wqkv)
        want_qkv, want_xn = fs.ln_gemm_plain(x, wqkv, ln=(ln1s, ln1b), return_xn=True)
        assert torch.equal(got_qkv, want_qkv) and torch.equal(got_xn, want_xn)
        xf = x.float()
        var = (xf - xf.mean(-1, keepdim=True)).square().mean(-1)
        torch.testing.assert_close(got_stats[:, 0], xf.mean(-1))
        torch.testing.assert_close(got_stats[:, 1], torch.rsqrt(var + 1e-5))
    elif name == "self_attention_x1":
        assert torch.equal(k6.self_attention_x1_plain(qkv, x, RH, n),
                           fs.self_attention_plain(qkv, x.float(), RH, n))
    elif name == "pair_cross_fwd":
        qc = fs.ln_gemm_plain(x1, wq, ln=(ln2s, ln2b))
        want, _ = fs.cross_attention_plain(qc, kv, x1, None, RH, n)
        assert torch.equal(k6.pair_cross_fwd_plain(x1, ln2s, ln2b, wq, kv, RH, n),
                           want.to(torch.bfloat16))
    elif name == "pair_cross_bwd":
        dqc, xn2, stats2, part = k6.pair_cross_bwd_plain(x1, ln2s, ln2b, wq, kv, g, RH, n)
        qc, want_xn2 = fs.ln_gemm_plain(x1, wq, ln=(ln2s, ln2b), return_xn=True)
        want_dqc, want_dkv = lv.cross_attention_bwd_plain(qc, kv, g.float(), RH, n)
        assert torch.equal(xn2, want_xn2) and torch.equal(dqc, want_dqc)
        assert part.shape == (2 * k6.pair_slots(n) * 2, 2 * RD)
        got = k6.pair_dkv_plain(part, b, n, RD, torch.float32)
        assert rel_l2(_np(got), _np(want_dkv)) < 4e-3
        assert torch.equal(k6.pair_dkv_plain(part, b, n, RD), got.to(torch.bfloat16))
    else:
        dqc = (torch.randn(b * n, RD, generator=torch.Generator().manual_seed(16)) * 0.1).to(
            torch.bfloat16)
        stats2 = k6.pair_qkv_plain(x1, ln2s, ln2b, wq)[2]
        for dy, w, xs, st, sc, up, dt in ((dqc, wq, x1, stats2, ln2s, g, torch.float32),
                                           (qkv, wqkv, x, stats1, ln1s, x1, torch.bfloat16)):
            out, part = k6.pair_ln_bwd_plain(dy, w, xs, st, sc, up, dt)
            dxn = dy.float() @ w.float()
            want, ds, db = lv.layernorm_bwd_plain(dxn, xs, sc, up.float())
            assert out.dtype == dt and part.shape == (2, 2 * RD)
            torch.testing.assert_close(out, want.to(dt), rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(part.sum(0), torch.cat([ds, db]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["pair_qkv", "self_attention_x1", "pair_cross_fwd",
                                  "pair_cross_bwd", "pair_ln_bwd"])
def test_route_wrappers_refuse_other_devices(name):
    """Each route kernel's wrapper runs its kernel on CUDA tensors or its
    plain version on CPU ones; on any other device (meta) it refuses."""
    b, n = ROUTE_CASES["n16"]
    x, cond, g, params, qkv, stats1, x1, kv = (
        t if not isinstance(t, torch.Tensor) else t.to("meta")
        for t in _route_stage_inputs(17))
    params = [p.to("meta") for p in params]
    ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv = params
    calls = {
        "pair_qkv": lambda: k6.pair_qkv(x, ln1s, ln1b, wqkv),
        "self_attention_x1": lambda: k6.self_attention_x1(qkv, x, RH, 13),
        "pair_cross_fwd": lambda: k6.pair_cross_fwd(x1, ln2s, ln2b, wq, kv, RH, 13),
        "pair_cross_bwd": lambda: k6.pair_cross_bwd(x1, ln2s, ln2b, wq, kv, g, RH, 13),
        "pair_ln_bwd": lambda: k6.pair_ln_bwd(
            qkv, wqkv, x, stats1, ln1s, x1, torch.bfloat16,
            torch.empty(2, 4 * RD, device="meta"), 0),
    }
    k6.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        calls[name]()
    assert not any(k6.LAUNCHES.values())


def test_pair_slots_bound_every_tile():
    """`pair_slots(n)` is at least the number of batch elements any
    128-row tile spans, for every n up to 300 (the per-element partials of
    a tile always have a slot): 2 from 128 tokens up, as at N = 144, 200
    and 256."""
    for n in range(1, 301):
        rows = n * 300
        spans = [((min(t + k6.BM, rows) - 1) // n) - t // n + 1 for t in range(0, rows, k6.BM)]
        assert max(spans) <= k6.pair_slots(n), n
    assert [k6.pair_slots(n) for n in (16, 13, 128, 144, 200, 256)] == [9, 11, 2, 2, 2, 2]
