"""The port's decoder-layer stack (ops/fused_stack.py) against the JAX
package's Pallas kernel `fused_layer_stack`, run in interpret mode.

On the CPU the port's wrappers run each kernel's plain PyTorch version;
the CUDA kernels themselves are checked against those plain versions on
the card (tests/test_torch_port_cuda.py, and chip_smoke.py)."""

from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from transformer_latent_diffusion_tpu.configs import DenoiserConfig
from transformer_latent_diffusion_tpu.models import Denoiser as JaxDenoiser
from transformer_latent_diffusion_tpu.ops.fused_stack import (
    fused_layer_stack as jax_fused_layer_stack,
)
from transformer_latent_diffusion_tpu.ops.fused_stack import (
    pack_layer_stack as jax_pack_layer_stack,
)
from transformer_latent_diffusion_tpu.utils import init_denoiser_params
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def tiny():
    """JAX params of the tiny DenoiserConfig (d=128, 3 layers, 8x8 grid)
    and the same weights as the port's state_dict."""
    import jax

    cfg = DenoiserConfig()
    params = init_denoiser_params(JaxDenoiser(**asdict(cfg)), cfg)
    sd = convert.denoiser_state_dict(jax.tree.map(np.asarray, params), cfg)
    return cfg, params, {k: torch.from_numpy(v) for k, v in sd.items()}


def _inputs(cfg, seed, b=2):
    rng = np.random.default_rng(seed)
    n = (cfg.image_size // cfg.patch_size) ** 2
    x = rng.standard_normal((b, n, cfg.embed_dim)).astype(np.float32)
    cond = rng.standard_normal((b, 2, cfg.embed_dim)).astype(np.float32)
    return x, cond


@pytest.mark.parametrize("layers", [[1], [0, 2]], ids=["one_layer", "two_layers"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_layer_stack_matches_jax_kernel(tiny, dtype, layers):
    """float32: atol 1e-4 / rtol 1e-3 (tests/test_fused_kernels.py's bound;
    only summation order and the TPU kernel's erf polynomial differ).
    bf16: max-abs within 0.02 x the output's scale, the bound of the JAX
    package's own bf16 kernel test (a one-step bf16 rounding flip of an
    intermediate moves the result by ~2^-8 relative)."""
    cfg, params, sd = tiny
    jdt, tdt = DTYPES[dtype]
    hw = cfg.image_size // cfg.patch_size
    n_heads = cfg.embed_dim // 64
    x, cond = _inputs(cfg, seed=len(layers))
    want = np.asarray(jax_fused_layer_stack(
        jnp.asarray(x, jdt), jnp.asarray(cond, jdt),
        jax_pack_layer_stack(params, layers, jdt), hw=hw, n_heads=n_heads,
        interpret=True).astype(jnp.float32))
    got = fs.fused_layer_stack(
        torch.from_numpy(x).to(tdt), torch.from_numpy(cond).to(tdt),
        fs.pack_layer_stack(sd, layers, tdt), hw=hw, n_heads=n_heads)
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    else:
        assert np.abs(got - want).max() < 0.02 * np.abs(want).max()


def test_pack_layer_stack_matches_jax_layout(tiny):
    """The packed weights are the JAX kernel's, with projections in the
    torch (out, in) layout."""
    cfg, params, sd = tiny
    want = jax_pack_layer_stack(params, [0, 2], jnp.float32)
    got = fs.pack_layer_stack(sd, [0, 2], torch.float32)
    assert set(got) == set(want)
    for key, value in want.items():
        value = np.asarray(value)
        if key in ("wqkv", "wq", "wkv", "w1", "w2"):
            value = value.transpose(0, 2, 1)
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_plain_stages_match_independent_forms():
    """Each stage's plain version against a formulation that shares no
    code with it: F.layer_norm + F.linear, F.conv2d (groups=C) + F.gelu,
    torch.softmax over explicit scores. float32 throughout; 1e-5 covers
    summation order only."""
    g = torch.Generator().manual_seed(0)
    b, hw, d, heads, hidden = 2, 4, 128, 2, 64
    n = hw * hw
    x = torch.randn(b * n, d, generator=g)
    scale, shift = torch.randn(d, generator=g), torch.randn(d, generator=g)
    w = torch.randn(3 * d, d, generator=g) / d ** 0.5
    want = F.linear(F.layer_norm(x, (d,), scale, shift, 1e-5), w)
    torch.testing.assert_close(fs.ln_gemm_plain(x, w, ln=(scale, shift)), want,
                               atol=1e-5, rtol=1e-5)

    h = torch.randn(b * n, hidden, generator=g)
    dw = torch.randn(9, hidden, generator=g)
    dwb = torch.randn(hidden, generator=g)
    grid = h.reshape(b, hw, hw, hidden).permute(0, 3, 1, 2)
    conv = F.conv2d(grid, dw.T.reshape(hidden, 1, 3, 3), dwb, padding=1,
                    groups=hidden)
    want = F.gelu(conv).permute(0, 2, 3, 1).reshape(b * n, hidden)
    torch.testing.assert_close(fs.dwconv_gelu_plain(h, dw, dwb, hw), want,
                               atol=1e-5, rtol=1e-5)

    qkv = torch.randn(b * n, 3 * d, generator=g)
    q, k, v = (t.reshape(b, n, heads, 64).transpose(1, 2) for t in qkv.chunk(3, -1))
    att = torch.softmax(q @ k.transpose(-1, -2) / 8.0, -1) @ v
    want = x + att.transpose(1, 2).reshape(b * n, d)
    torch.testing.assert_close(fs.self_attention_plain(qkv, x, heads, n), want,
                               atol=1e-5, rtol=1e-5)

    kv = torch.randn(b * 2, 2 * d, generator=g)
    qc = torch.randn(b * n, d, generator=g)
    q = qc.reshape(b, n, heads, 64).transpose(1, 2)
    kk, vv = (t.reshape(b, 2, heads, 64).transpose(1, 2)
              for t in kv.reshape(b, 2, 2 * d).chunk(2, -1))
    att = torch.softmax(q @ kk.transpose(-1, -2) / 8.0, -1) @ vv
    want = x + att.transpose(1, 2).reshape(b * n, d)
    got, xn = fs.cross_attention_plain(qc, kv, x, (scale, shift), heads, n)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(xn, F.layer_norm(want, (d,), scale, shift, 1e-5),
                               atol=1e-5, rtol=1e-5)


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


@pytest.mark.parametrize("name", fs.KERNELS)
def test_wrapper_dispatches_by_device(name):
    """CPU tensors take the plain version (and count no launch); tensors on
    any device other than CUDA raise instead of falling back."""
    fs.reset_launch_counts()
    wrapper, plain = getattr(fs, name), getattr(fs, f"{name}_plain")
    args, kw = _stage_args(name, "cpu")
    torch.testing.assert_close(wrapper(*args, **kw), plain(*args, **kw),
                               atol=0, rtol=0)
    assert fs.LAUNCHES == {k: 0 for k in fs.KERNELS}
    args, kw = _stage_args(name, "meta")
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args, **kw)
