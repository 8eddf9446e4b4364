"""The port's differentiable decoder layer (ops/fused_layer_vjp.py, TPU
kernel K2) against the JAX package's `fused_layer_vjp`, run in interpret
mode as tests/test_fused_layer_vjp.py runs it, on the same inputs made with
numpy from a seed: the forward and all 17 gradients (dx, dcond and the 15
parameter gradients).

On the CPU the port's kernel wrappers run their plain versions, so
`FusedLayerFunction` here exercises the kernel path's composition (the
recompute, the order of the backward stages, the operand layouts) and
`fused_layer_*_plain` the whole-layer math. The CUDA kernels are held
against the plain versions on the card (tests/test_torch_port_cuda.py, and
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.ops.fused_layer_vjp import fused_layer_vjp
from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv

torch.set_num_threads(2)

B, HW, D, H, HID = 2, 4, 64, 2, 128
N = HW * HW
NAMES = ("x", "cond") + lv.PARAM_NAMES
# JAX layout -> port layout of each argument (projections transposed to
# (out, in), the depthwise taps to (9, hidden))
TO_PORT = {"wqkv": np.transpose, "wq": np.transpose, "wkv": np.transpose,
           "w1": np.transpose, "w2": np.transpose,
           "dw": lambda a: a.reshape(9, HID)}
LOWP = ("x", "cond", "wqkv", "wq", "wkv", "w1", "dw", "w2")


def _jax_args(seed):
    """The JAX test's inputs (tests/test_fused_layer_vjp.py:_random_args)."""
    rng = np.random.default_rng(seed)

    def arr(*s):
        return (rng.standard_normal(s) * 0.3).astype(np.float32)

    ones = np.ones(D, np.float32)
    return [arr(B, N, D), arr(B, 2, D), ones, arr(D), arr(D, 3 * D), ones,
            arr(D), arr(D, D), arr(D, 2 * D), ones, arr(D), arr(D, HID),
            arr(HID), arr(3, 3, HID), arr(HID), arr(HID, D), arr(D)]


def _port(name, a):
    return TO_PORT.get(name, lambda v: v)(np.array(a, np.float32))


def _cast(args, bf16):
    """JAX arrays, with the weights and activations in bf16 if asked (as
    the JAX DecoderBlock feeds its kernel); LayerNorm and biases float32."""
    out = []
    for name, a in zip(NAMES, args):
        dt = jnp.bfloat16 if bf16 and name in LOWP else jnp.float32
        out.append(jnp.asarray(a).astype(dt))
    return out


def _torch(jargs, requires_grad=False):
    ts = []
    for name, a in zip(NAMES, jargs):
        dt = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
        t = torch.from_numpy(np.ascontiguousarray(_port(name, a))).to(dt)
        ts.append(t.requires_grad_(requires_grad))
    return ts


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_forward_matches_jax_float32():
    """float32 at the JAX test's own bound (atol 3e-4, rtol 1e-3): the
    whole-layer plain forward and the kernel path's composition."""
    jargs = _cast(_jax_args(0), False)
    want = np.asarray(fused_layer_vjp(*jargs, H, HW, True))
    x, cond, *params = _torch(jargs)
    for got in (lv.fused_layer_fwd_plain(x, cond, params, H, HW),
                lv.fused_layer(x, cond, params, H, HW)):
        np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=1e-3)


def _jax_grads(jargs, g):
    _, vjp = jax.vjp(lambda *a: fused_layer_vjp(*a, H, HW, True), *jargs)
    return vjp(g)


@pytest.mark.parametrize("path", ["function", "plain"])
def test_gradients_match_jax_float32(path):
    """All 17 gradients of mean(sin(layer)) in float32 at the JAX test's
    bound (atol 1e-3, rtol 1e-2), through `FusedLayerFunction` (autograd
    over the kernel path) and through `fused_layer_bwd_plain`."""
    jargs = _cast(_jax_args(1), False)

    def loss(*a):
        return jnp.mean(jnp.sin(fused_layer_vjp(*a, H, HW, True)))

    want = jax.grad(loss, argnums=tuple(range(17)))(*jargs)
    ts = _torch(jargs, requires_grad=(path == "function"))
    x, cond, *params = ts
    if path == "function":
        torch.sin(lv.fused_layer(x, cond, params, H, HW)).mean().backward()
        got = [t.grad for t in ts]
    else:
        out = lv.fused_layer_fwd_plain(x, cond, params, H, HW)
        g = torch.cos(out) / out.numel()
        dx, dcond, grads = lv.fused_layer_bwd_plain(x, cond, g, params, H, HW)
        got = [dx, dcond, *grads]
    for name, w, gt in zip(NAMES, want, got):
        np.testing.assert_allclose(gt.detach().float().numpy(),
                                   _port(name, w), atol=1e-3, rtol=1e-2,
                                   err_msg=f"grad mismatch: {name}")


# bf16 per-leaf rel-L2 bound. Both sides round at the same points (the
# TPU kernel's), so what differs is float32 summation order and the
# TPU kernel's erf polynomial (< 1.5e-7): each can flip a bf16 rounding
# (2^-8 relative) of an intermediate, which then propagates. Measured
# worst leaf 3.7e-4 (wq) on the CPU; the bound is 2.5 bf16 steps.
BF16_LEAF_REL_L2 = 1e-2


def test_bf16_forward_and_gradients_match_jax():
    """bf16 activations and weights (LayerNorm and biases float32), an
    upstream gradient in bf16: forward and all 17 cotangents, per leaf
    rel-L2 < BF16_LEAF_REL_L2. The weight gradients come back in bf16, as
    the JAX custom VJP casts them to the parameters' dtype."""
    jargs = _cast(_jax_args(2), True)
    g = np.random.default_rng(3).standard_normal((B, N, D)).astype(np.float32)
    jg = jnp.asarray(g).astype(jnp.bfloat16)
    want_out = fused_layer_vjp(*jargs, H, HW, True)
    want = _jax_grads(jargs, jg)

    ts = _torch(jargs, requires_grad=True)
    x, cond, *params = ts
    out = lv.fused_layer(x, cond, params, H, HW)
    assert out.dtype == torch.bfloat16
    assert _rel_l2(out.detach().float().numpy(),
                   np.asarray(want_out, np.float32)) < 1e-2
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    for name, w, t in zip(NAMES, want, ts):
        assert t.grad.dtype == t.dtype, name
        r = _rel_l2(t.grad.float().numpy(), _port(name, w))
        assert r < BF16_LEAF_REL_L2, (name, r)


def test_plain_and_kernel_path_agree_bf16():
    """The kernel path's composition (each stage's plain version) against
    the whole-layer plain backward, bf16: the same rounding points in the
    same order, so they agree to float32 summation noise."""
    jargs = _cast(_jax_args(4), True)
    x, cond, *params = _torch(jargs)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, N, D)).astype(np.float32)).to(torch.bfloat16)
    a = lv.fused_layer_bwd(x, cond, g, params, H, HW)
    b = lv.fused_layer_bwd_plain(x, cond, g, params, H, HW)
    for name, u, v in zip(NAMES, [a[0], a[1], *a[2]], [b[0], b[1], *b[2]]):
        assert _rel_l2(u.float().numpy(), v.float().numpy()) < 1e-2, name


def _kernel_cases(dev):
    """(name, kernel call, plain call) of every new kernel at a small
    shape on `dev`, inputs from a seed."""
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


@pytest.mark.parametrize("name", [c[0] for c in _kernel_cases("cpu")])
def test_wrappers_take_the_plain_version_on_cpu(name):
    """On CPU tensors each wrapper is its plain version, and launches
    nothing."""
    lv.reset_launch_counts()
    kern, plain = next((k, p) for n, k, p in _kernel_cases("cpu") if n == name)
    got, want = kern(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for u, v in zip(got, want):
        torch.testing.assert_close(u, v, atol=0, rtol=0)
    assert all(v == 0 for v in lv.LAUNCHES.values())
