"""The port's plain Denoiser and fused engine against the JAX package's,
on the same weights (converted with convert.denoiser_state_dict) and the
same numpy inputs, at the tiny DenoiserConfig (d=128, 3 layers, 8x8 grid)."""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.configs import DenoiserConfig
from transformer_latent_diffusion_tpu.models import Denoiser as JaxDenoiser
from transformer_latent_diffusion_tpu.models.denoiser import patchify as jax_patchify
from transformer_latent_diffusion_tpu.models.denoiser import (
    unpatchify as jax_unpatchify,
)
from transformer_latent_diffusion_tpu.models.fast_denoiser import (
    make_fused_apply as jax_make_fused_apply,
)
from transformer_latent_diffusion_tpu.models.torch_compat import (
    export_torch_denoiser_state_dict,
)
from transformer_latent_diffusion_tpu.utils import init_denoiser_params
from transformer_latent_diffusion_tpu_torch import configs as port_configs
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models.denoiser import (
    Denoiser,
    patchify,
    unpatchify,
)
from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import (
    make_fused_apply,
)
from transformer_latent_diffusion_tpu_torch.ops.fused_stack import (
    fused_layer_stack,
    pack_layer_stack,
)

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def tiny():
    cfg = DenoiserConfig()
    params = init_denoiser_params(JaxDenoiser(**asdict(cfg)), cfg)
    np_params = jax.tree.map(np.asarray, params)
    return cfg, params, np_params


def _port_model(cfg, np_params, dtype):
    model = Denoiser.from_config(port_configs.DenoiserConfig(**asdict(cfg)),
                                 dtype=dtype)
    sd = convert.denoiser_state_dict(np_params, cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model.eval()


def _inputs(cfg, seed, b=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 4, cfg.image_size, cfg.image_size)).astype(np.float32)
    nl = rng.uniform(0.01, 0.99, (b, 1)).astype(np.float32)
    label = rng.standard_normal((b, cfg.text_emb_size)).astype(np.float32)
    return x, nl, label


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_denoiser_state_dict_matches_torch_export(tiny):
    """convert.denoiser_state_dict gives the reference layout that the JAX
    package's own exporter (torch_compat) writes: same keys, same values."""
    cfg, params, np_params = tiny
    want = export_torch_denoiser_state_dict(params, cfg)
    got = convert.denoiser_state_dict(np_params, cfg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("patch", [1, 2, 4])
def test_patchify_roundtrip_matches_jax(patch):
    x = np.random.default_rng(patch).standard_normal((2, 4, 8, 8)).astype(np.float32)
    want = np.asarray(jax_patchify(jnp.asarray(x), patch))
    got = patchify(torch.from_numpy(x), patch)
    np.testing.assert_array_equal(got.numpy(), want)
    h = 8 // patch
    np.testing.assert_array_equal(
        unpatchify(got, patch, h, h, 4).numpy(),
        np.asarray(jax_unpatchify(jnp.asarray(want), patch, h, h, 4)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_denoiser_matches_jax(tiny, dtype):
    """float32: atol 1e-4 / rtol 1e-3 (same math, other summation order).
    bf16: both compute every dense layer and residual add in bf16, but the
    frameworks round at slightly different points (bias adds, GELU, the
    depthwise taps), so max-abs within 0.03 x the output's scale."""
    cfg, params, np_params = tiny
    jdt, tdt = DTYPES[dtype]
    x, nl, label = _inputs(cfg, seed=0)
    jmodel = JaxDenoiser(**asdict(cfg), dtype=jdt)
    want = np.asarray(jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a))(
        params, x, nl, label))
    with torch.no_grad():
        got = _port_model(cfg, np_params, tdt)(*_torch(x, nl, label)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    else:
        assert np.abs(got - want).max() < 0.03 * np.abs(want).max()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_engine_matches_jax_engine(tiny, dtype):
    """The port's FusedEngine (plain stage versions on the CPU) against the
    JAX engine with its Pallas kernel in interpret mode. Bounds as in
    tests/test_fused_kernels.py: atol 1e-4 / rtol 1e-3 in float32, max-abs
    within 0.02 x scale in bf16."""
    cfg, params, np_params = tiny
    jdt, tdt = DTYPES[dtype]
    x, nl, label = _inputs(cfg, seed=1, b=2)
    want = np.asarray(jax_make_fused_apply(cfg, compute_dtype=jdt, interpret=True)(
        params, x, nl, label))
    engine = make_fused_apply(port_configs.DenoiserConfig(**asdict(cfg)),
                              compute_dtype=tdt)
    model = _port_model(cfg, np_params, tdt)
    with torch.no_grad():
        got = engine(model.state_dict(), *_torch(x, nl, label)).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    else:
        assert np.abs(got - want).max() < 0.02 * np.abs(want).max()


def test_fused_engine_matches_plain_denoiser(tiny):
    """Within the port: the engine and the plain Denoiser are the same
    function of the same state_dict (float32, summation order only)."""
    cfg, _, np_params = tiny
    model = _port_model(cfg, np_params, torch.float32)
    engine = make_fused_apply(port_configs.DenoiserConfig(**asdict(cfg)),
                              compute_dtype=torch.float32)
    x, nl, label = _torch(*_inputs(cfg, seed=2))
    with torch.no_grad():
        torch.testing.assert_close(engine(model.state_dict(), x, nl, label),
                                   model(x, nl, label), atol=1e-4, rtol=1e-3)


def test_fused_engine_rounds_between_layers(tiny):
    """bf16: the engine makes one fused_layer_stack call per layer, as the
    JAX engine runs one kernel call per layer, so the residual is rounded
    to bf16 between layers. Its output is exactly that composition, and
    not that of one call over all layers (float32 residual throughout)."""
    cfg, _, np_params = tiny
    model = _port_model(cfg, np_params, torch.bfloat16)
    sd = model.state_dict()
    engine = make_fused_apply(port_configs.DenoiserConfig(**asdict(cfg)),
                              compute_dtype=torch.bfloat16)
    x, nl, label = _torch(*_inputs(cfg, seed=3, b=2))
    with torch.no_grad():
        got = engine(sd, x, nl, label)
        tokens, cond, h, w = engine._prologue(sd, x, nl, label)
        per_layer, one_call = tokens, tokens
        for i in range(cfg.n_layers):
            per_layer = fused_layer_stack(
                per_layer, cond, pack_layer_stack(sd, [i], torch.bfloat16),
                hw=h, n_heads=engine.n_heads)
        one_call = fused_layer_stack(
            one_call, cond,
            pack_layer_stack(sd, list(range(cfg.n_layers)), torch.bfloat16),
            hw=h, n_heads=engine.n_heads)
        torch.testing.assert_close(got, engine._epilogue(sd, per_layer, h, w),
                                   atol=0, rtol=0)
        assert not torch.equal(got, engine._epilogue(sd, one_call, h, w))


def test_engine_options_not_ported_raise(tiny):
    """Block caching raised here until it was ported: the engine now has
    the JAX engine's cached span (the middle half of the layers; its
    forward is held against JAX in tests/test_torch_port_block_cache.py).
    mlp_class="moe" raised too before the MoE FFN was ported; now the
    Denoiser builds with the MoE FFN in every block (the JAX leaves'
    names), and an unknown FFN raises ValueError."""
    cfg = port_configs.DenoiserConfig()
    assert make_fused_apply(cfg).cache_span() == (0, 3)
    assert make_fused_apply(port_configs.DenoiserConfig(
        n_layers=12)).cache_span() == (3, 9)
    moe = Denoiser.from_config(port_configs.DenoiserConfig(mlp_class="moe", n_experts=4))
    sd = moe.state_dict()
    assert sd["denoiser_trans_block.decoder_blocks.0.mlp.wi"].shape == (4, 128, 512)
    assert sd["denoiser_trans_block.decoder_blocks.0.mlp.router.weight"].shape == (4, 128)
    with pytest.raises(ValueError, match="mlp_class"):
        Denoiser.from_config(port_configs.DenoiserConfig(mlp_class="conv"))
