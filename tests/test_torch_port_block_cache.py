"""Block caching (Delta-DiT) on the port's fused engine against the JAX
engine's, which runs its Pallas kernel in interpret mode as
tests/test_block_cache.py runs it: the cached forward with refresh true
and false, the sampler's `cache_interval` through `generate`, and the
W8A8 engine's cached forward. float32 engines on the CPU (the kernels'
plain versions), 4 layers so the cached span (layers 1-2) has layers on
both sides."""

from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.configs import DenoiserConfig
from transformer_latent_diffusion_tpu.models import Denoiser as JaxDenoiser
from transformer_latent_diffusion_tpu.models.fast_denoiser import (
    make_fused_apply as jax_make_fused_apply,
)
from transformer_latent_diffusion_tpu.sampling import DiffusionGenerator as JaxGenerator
from transformer_latent_diffusion_tpu.utils import init_denoiser_params
from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import make_fused_apply
from transformer_latent_diffusion_tpu_torch.sampling.diffusion import DiffusionGenerator

torch.set_num_threads(2)

CFG = replace(DenoiserConfig(), n_layers=4)  # d = 128, 16 px latents: 8 x 8 tokens
# the float32 engines sum in other orders (tests/test_fused_kernels.py's
# bounds: atol 1e-4, rtol 1e-3 for one forward); a 6-step trajectory is
# held to rel-L2 1e-4 (measured ~1e-6 on the uncached slice)
TRAJ_REL_L2 = 1e-4


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxDenoiser(**asdict(CFG))
    params = init_denoiser_params(jmodel, CFG)
    model = Denoiser.from_config(pc.DenoiserConfig(**asdict(CFG)))
    sd = convert.denoiser_state_dict(jax.tree.map(np.asarray, params), CFG)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jengine = jax_make_fused_apply(CFG, compute_dtype=jnp.float32, interpret=True)
    engine = make_fused_apply(pc.DenoiserConfig(**asdict(CFG)), compute_dtype=torch.float32)
    return (jmodel, params, jengine), (model.eval(), engine)


def _inputs(b=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 4, 16, 16)).astype(np.float32)
    nl = np.full((b, 1), 0.5, np.float32)
    label = rng.standard_normal((b, CFG.text_emb_size)).astype(np.float32)
    return x, nl, label


def test_cached_forward_matches_jax(setup):
    """refresh true: the output and the delta against the JAX engine's
    (atol 1e-4, rtol 1e-3 of one float32 forward), and the output equals
    the uncached forward bit for bit (the same stages in the same order).
    refresh false with that delta: the full forward again (atol 1e-5, the
    bound of tests/test_block_cache.py: tokens + (out - tokens) rounds
    once), and the delta passed through bit-equal."""
    (jmodel, params, jengine), (model, engine) = setup
    x, nl, label = _inputs()
    jprep = jengine.prepare(params)
    assert engine.cache_span() == jengine.cache_span() == (1, 3)
    delta0 = jnp.zeros((2, 64, CFG.embed_dim), jnp.float32)
    jout, jdelta = jengine.apply_prepared_cached(jprep, x, nl, label, delta0,
                                                 jnp.asarray(True))
    jout2, jdelta2 = jengine.apply_prepared_cached(jprep, x, nl, label, jdelta,
                                                   jnp.asarray(False))
    prep = engine.prepare(model.state_dict())
    args = [torch.from_numpy(a) for a in (x, nl, label)]
    with torch.no_grad():
        full = engine.apply_prepared(prep, *args)
        out, delta = engine.apply_prepared_cached(prep, *args, None, True)
        out2, delta2 = engine.apply_prepared_cached(prep, *args, delta, False)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(out2.numpy(), np.asarray(jout2), atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(out, full, atol=0, rtol=0)
    assert delta.abs().max() > 0 and delta.dtype == torch.float32
    torch.testing.assert_close(out2, full, atol=1e-5, rtol=1e-5)
    assert delta2 is delta


def test_cache_interval_one_is_the_exact_path(setup):
    """cache_interval=1 is the exact loop, bit for bit."""
    _, (model, engine) = setup
    gen = DiffusionGenerator(model, fast_apply=engine, device="cpu")
    labels = np.ones((2, CFG.text_emb_size), np.float32)
    kw = dict(num_imgs=2, img_size=16, n_iter=6, seed=3, sharp_f=0, bright_f=0,
              use_ddpm_plus=False)
    _, exact = gen.generate(labels, **kw)
    _, cached1 = gen.generate(labels, cache_interval=1, **kw)
    torch.testing.assert_close(cached1, exact, atol=0, rtol=0)


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_cache_interval_two_matches_jax(setup, sampler):
    """cache_interval=2 through `generate` on the same weights and initial
    noise as the JAX generator's (its engine in interpret mode):
    TRAJ_REL_L2 (measured 1.1e-6), where caching itself moves the result
    by more."""
    (jmodel, params, jengine), (model, engine) = setup
    labels = np.random.default_rng(1).standard_normal((2, CFG.text_emb_size)).astype(np.float32)
    noise = np.random.default_rng(2).standard_normal((2, 4, 16, 16)).astype(np.float32)
    kw = dict(labels=labels, num_imgs=2, img_size=16, n_iter=6, seeds=noise,
              sharp_f=0, bright_f=0, class_guidance=4.0, sampler=sampler,
              cache_interval=2)
    jgen = JaxGenerator(model=jmodel, params=params, vae=None, fast_apply=jengine)
    _, want = jgen.generate(**kw)
    _, exact = jgen.generate(**{**kw, "cache_interval": 1})
    gen = DiffusionGenerator(model, fast_apply=engine, device="cpu")
    _, got = gen.generate(**kw)
    assert np.abs(np.asarray(want) - np.asarray(exact)).max() > 1e-4  # lossy
    a, b = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < TRAJ_REL_L2


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_cached_refresh_is_the_forward_on_both_engines(setup, quantize):
    """The bf16 and W8A8 engines (plain versions) share the cached method:
    refresh true is bit-equal to the forward, refresh false adds the
    delta in the compute dtype."""
    _, (model, _) = setup
    engine = make_fused_apply(pc.DenoiserConfig(**asdict(CFG)),
                              compute_dtype=torch.bfloat16, quantize=quantize)
    prep = engine.prepare(model.state_dict())
    args = [torch.from_numpy(a) for a in _inputs(seed=4)]
    with torch.no_grad():
        full = engine.apply_prepared(prep, *args)
        out, delta = engine.apply_prepared_cached(prep, *args, None, True)
        out2, delta2 = engine.apply_prepared_cached(prep, *args, delta, False)
    torch.testing.assert_close(out, full, atol=0, rtol=0)
    assert delta.dtype == torch.bfloat16 and delta2 is delta
    assert torch.isfinite(out2).all()
    assert (out2 - full).abs().max() < 0.05 * full.abs().max()


def test_widened_model_samples_exactly_and_warns(setup):
    """A widened (context-channel, outpainting) model does not block-cache:
    JAX's fused engine does not take it, so its generator samples exactly
    and warns (sampling/diffusion.py:332-334, 398-405). The port keeps the
    engine route and does the same: cache_interval=3 warns and gives the
    cache_interval=1 trajectory bit for bit."""
    from transformer_latent_diffusion_tpu_torch.models.denoiser import expand_input_channels

    _, (model, _) = setup
    wide_cfg = pc.DenoiserConfig(**{**asdict(CFG), "input_channels": 8})
    sd = expand_input_channels(model.state_dict(), 4, 8, CFG.patch_size)
    name = "denoiser_trans_block.patchify_and_embed.0.weight"
    gen_w = torch.Generator().manual_seed(5)  # context weights that matter
    sd[name][:, 4:] = 0.05 * torch.randn(sd[name][:, 4:].shape, generator=gen_w)
    wide = Denoiser.from_config(wide_cfg)
    wide.load_state_dict(sd)
    gen = DiffusionGenerator(wide.eval(), fast_apply=make_fused_apply(
        wide_cfg, compute_dtype=torch.float32), device="cpu")
    assert gen.uses_engine(16)  # the engine route stays
    labels = np.random.default_rng(1).standard_normal((2, CFG.text_emb_size)).astype(np.float32)
    ctx = np.random.default_rng(2).standard_normal((2, 4, 16, 16)).astype(np.float32)
    kw = dict(num_imgs=2, img_size=16, n_iter=7, seed=3, sharp_f=0, bright_f=0,
              sampler="ddim", context_latents=ctx)
    _, exact = gen.generate(labels, cache_interval=1, **kw)
    with pytest.warns(UserWarning, match="falling back to exact sampling"):
        _, cached = gen.generate(labels, cache_interval=3, **kw)
    torch.testing.assert_close(cached, exact, atol=0, rtol=0)
