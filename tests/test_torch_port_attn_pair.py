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
