"""The port's sampler against the JAX package's: the schedule pieces, the
text-to-image slice as a whole (prompt -> CLIP -> DDIM or DPM++ with CFG
-> VAE -> uint8) on the same weights and initial noise, the replay of the
committed flagship golden, and the pipeline entry points."""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.configs import DenoiserConfig
from transformer_latent_diffusion_tpu.models import Denoiser as JaxDenoiser
from transformer_latent_diffusion_tpu.models.clip import FlaxClip
from transformer_latent_diffusion_tpu.models.vae import FlaxVae
from transformer_latent_diffusion_tpu.sampling import diffusion as jd
from transformer_latent_diffusion_tpu.utils import init_denoiser_params
from transformer_latent_diffusion_tpu.utils.goldens import (
    GOLDEN_DENOISER,
    GOLDEN_SPEC,
    load_golden,
    rel_l2,
)
from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models.clip import ClipTextModel
from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
from transformer_latent_diffusion_tpu_torch.models.vae import VaeDecoder
from transformer_latent_diffusion_tpu_torch.sampling import diffusion as td
from transformer_latent_diffusion_tpu_torch.sampling.pipeline import (
    DiffusionTransformer,
)

torch.set_num_threads(2)


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return module.eval()


@pytest.mark.parametrize("kind", td.NOISE_SCHEDULES)
def test_noise_levels_and_step_coeffs_match_jax(kind):
    """Host-side float64 numpy on both sides: exact equality."""
    for n_iter in (1, 2, 5, 50):
        want = jd.make_noise_levels(n_iter, 1.5, kind)
        got = td.make_noise_levels(n_iter, 1.5, kind)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(td.shift_noise_levels(got, 2.5),
                                      jd.shift_noise_levels(want, 2.5))
        for dpm in (False, True):
            for a, b in zip(td.make_step_coeffs(got, dpm),
                            jd.make_step_coeffs(want, dpm)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("objective", td.PREDICTION_OBJECTIVES)
def test_cfg_combine_and_prediction_to_x0_match_jax(objective):
    """float32 elementwise math: 1e-6."""
    rng = np.random.default_rng(0)
    cond, uncond, x_t = (rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
                         for _ in range(3))
    for g in (np.float32(6.0), np.array([1.0, 3.0, 7.5], np.float32)):
        want = np.asarray(jd.prediction_to_x0(
            jd.cfg_combine(jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(g)),
            jnp.asarray(x_t), 0.37, objective))
        got = td.prediction_to_x0(
            td.cfg_combine(torch.from_numpy(cond), torch.from_numpy(uncond),
                           torch.from_numpy(np.asarray(g))),
            torch.from_numpy(x_t), 0.37, objective)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    sigma = np.array([0.2, 0.5, 0.9], np.float32)
    want = np.asarray(jd.prediction_to_x0(jnp.asarray(cond), jnp.asarray(x_t),
                                          jnp.asarray(sigma), objective))
    got = td.prediction_to_x0(torch.from_numpy(cond), torch.from_numpy(x_t),
                              torch.from_numpy(sigma), objective)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def towers():
    """The tiny towers of both packages on the same weights."""
    cfg = DenoiserConfig()
    jmodel = JaxDenoiser(**asdict(cfg))
    params = init_denoiser_params(jmodel, cfg)
    jclip = FlaxClip.create(width=64, heads=2, layers=2, dtype=jnp.float32)
    jvae = FlaxVae.create(block_out_channels=(8, 16), layers_per_block=1,
                          sample_size=8)

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    model = _load(Denoiser.from_config(pc.DenoiserConfig(**asdict(cfg))),
                  convert.denoiser_state_dict(np_tree(params), cfg))
    clip = _load(ClipTextModel(width=64, heads=2, layers=2),
                 convert.clip_text_state_dict(np_tree(jclip.params)))
    vae = _load(VaeDecoder((8, 16), layers_per_block=1),
                convert.vae_decoder_state_dict(np_tree(jvae.params)))
    return cfg, (jmodel, params, jclip, jvae), (model, clip, vae)


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_text_to_image_slice_matches_jax(towers, sampler):
    """Prompt -> CLIP -> 5-step sampling with CFG 6 (DPM++ also with a
    negative prompt) -> VAE -> uint8, each side on its own towers, the
    same weights and the same initial noise. float32: the final latents
    agree to rel-L2 1e-4 (measured ~1e-6; summation order through 6
    denoiser calls), the images to 1 LSB (a value at a rounding edge)."""
    cfg, (jmodel, params, jclip, jvae), (model, clip, vae) = towers
    prompts = ["a cute cat", "a red car on a road"]
    negative = None if sampler == "ddim" else ["blurry", "blurry"]
    noise = np.random.default_rng(3).standard_normal(
        (2, 4, cfg.image_size, cfg.image_size)).astype(np.float32)
    kw = dict(n_iter=5, num_imgs=2, class_guidance=6, seeds=noise,
              img_size=cfg.image_size, output="uint8", sampler=sampler)

    jgen = jd.DiffusionGenerator(model=jmodel, params=params, vae=jvae)
    jimg, jlat = jgen.generate(
        labels=jclip.encode_text(prompts),
        negative_labels=None if negative is None else jclip.encode_text(negative),
        **kw)
    gen = td.DiffusionGenerator(model, vae=vae, device="cpu")
    img, lat = gen.generate(
        labels=clip.encode_text(prompts),
        negative_labels=None if negative is None else clip.encode_text(negative),
        **kw)
    assert img.dtype == torch.uint8 and img.shape == (2, 32, 32, 3)
    assert rel_l2(lat.numpy(), np.asarray(jlat)) < 1e-4
    diff = np.abs(img.numpy().astype(int) - np.asarray(jimg).astype(int))
    assert diff.max() <= 1


def test_flagship_golden_replay():
    """Replays tests/goldens/flagship_latents.npz (the JAX package's CPU
    float32 run: flagship 101M denoiser, 4 images, 8 DDIM steps, CFG 6,
    no VAE) through the port's plain float32 path, with the same params
    (JAX init, converted), labels and explicit initial noise. The JAX
    package budgets 0.05 rel-L2 for its TPU run against this golden; the
    port on the CPU measures ~1.4e-6, so the bound here is 1e-4."""
    jcfg = DenoiserConfig(**GOLDEN_DENOISER)
    params = init_denoiser_params(JaxDenoiser(**asdict(jcfg)), jcfg)
    model = _load(Denoiser.from_config(pc.DenoiserConfig(**GOLDEN_DENOISER)),
                  convert.denoiser_state_dict(jax.tree.map(np.asarray, params), jcfg))
    del params
    spec = GOLDEN_SPEC
    shape = (spec["num_imgs"], 4, spec["img_size"], spec["img_size"])
    labels = jax.random.normal(jax.random.PRNGKey(spec["label_seed"]),
                               (spec["num_imgs"], jcfg.text_emb_size))
    noise = jax.random.normal(jax.random.PRNGKey(spec["seed"]), shape,
                              dtype=jnp.float32)
    _, lat = td.DiffusionGenerator(model, device="cpu").generate(
        labels=np.asarray(labels), n_iter=spec["n_iter"],
        num_imgs=spec["num_imgs"], class_guidance=spec["class_guidance"],
        img_size=spec["img_size"], sharp_f=0.0, bright_f=0.0,
        use_ddpm_plus=False, seeds=np.asarray(noise))
    assert rel_l2(lat.numpy(), load_golden()) < 1e-4


def test_generator_requires_a_device():
    """The generator is an entry point: it runs where the caller says,
    never on a default device."""
    with pytest.raises(TypeError, match="device"):
        td.DiffusionGenerator(Denoiser.from_config(pc.DenoiserConfig()))


def _tiny_ltd(**kw):
    kw.setdefault("vae_cfg", pc.VaeConfig(block_out_channels=(8, 16),
                                          layers_per_block=1))
    kw.setdefault("clip_cfg", pc.ClipConfig(width=64, heads=2, layers=2))
    return pc.LTDConfig(**kw)


def test_pipeline_entry_points_on_cpu():
    """generate_array_from_text / generate_image_from_text: shapes, uint8,
    same seed -> same pixels, another seed -> other pixels, bucket padding
    returns the requested count."""
    tr = DiffusionTransformer(_tiny_ltd(), device="cpu")
    a = tr.generate_array_from_text("a cute cat", num_imgs=2, n_iter=4, seed=5)
    assert a.shape == (2, 32, 32, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(
        a, tr.generate_array_from_text("a cute cat", num_imgs=2, n_iter=4, seed=5))
    assert not np.array_equal(
        a, tr.generate_array_from_text("a cute cat", num_imgs=2, n_iter=4, seed=6))
    assert tr.generate_array_from_text(["a", "b", "c"], n_iter=4,
                                       pad_to=4).shape == (3, 32, 32, 3)
    img = tr.generate_image_from_text("a cute cat", num_imgs=4, n_iter=4,
                                      sampler="ddim")
    assert img.mode == "RGB" and img.size == (4 + 2 * 36, 4 + 2 * 36)


def test_image_grids_match_jax():
    """uint8_grid_to_pil and to_pil give the JAX package's pixels."""
    from transformer_latent_diffusion_tpu.utils import common as jax_common
    from transformer_latent_diffusion_tpu_torch.utils import common

    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (5, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        np.asarray(common.uint8_grid_to_pil(imgs, nrow=2, padding=4)),
        np.asarray(jax_common.uint8_grid_to_pil(imgs, nrow=2, padding=4)))
    chw = rng.uniform(-0.2, 1.2, (3, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(common.to_pil(chw)),
                                  np.asarray(jax_common.to_pil(chw)))


def test_cuda_configs_the_kernels_cannot_run_raise_at_construction():
    """On CUDA the fused engine takes bf16 or float32 weights and has no
    switch off its kernels: a float16 denoiser or use_pallas=False is
    refused when the transformer is built, before any tensor reaches the
    device (so this runs without a card), not on the first request. (The
    JAX default, float32, builds on CUDA: tests/test_torch_port_float32_engine.py.)"""
    f16 = pc.DenoiserLoad(dtype="float16")
    with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
        DiffusionTransformer(_tiny_ltd(denoiser_load=f16), device="cuda")
    bf16 = pc.DenoiserLoad(dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="use_pallas"):
        DiffusionTransformer(_tiny_ltd(denoiser_load=bf16, use_pallas=False),
                             device="cuda")
    # the CPU runs the plain versions whatever use_pallas says
    tr = DiffusionTransformer(_tiny_ltd(use_pallas=False), device="cpu")
    assert tr.diffuser.fast_apply is None


def test_options_not_ported_raise():
    """What the slice leaves out raises NotImplementedError naming its
    ROADMAP item instead of running something else: parallelism and LoRA.
    (The CLIP vocab, the sampler extras, block caching and the editing
    inputs raised here too until they were ported; they run in the tests
    below and in tests/test_torch_port_editing.py.)"""
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        DiffusionTransformer(_tiny_ltd(mesh_shape=(8, 1)), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        DiffusionTransformer(_tiny_ltd(pipeline_microbatches=4), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        DiffusionTransformer(_tiny_ltd(lora_scale=0.5), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        td.DiffusionGenerator(Denoiser.from_config(pc.DenoiserConfig()), device="cpu",
                              mesh=object())


@pytest.mark.parametrize("kw", [
    dict(sampler="heun"), dict(eta=0.5, sampler="ddim"), dict(cfg_rescale=0.5),
    dict(guidance_interval=(0.1, 0.9)), dict(cache_interval=2)],
    ids=["heun", "eta", "cfg_rescale", "guidance_interval", "cache_interval"])
def test_sampler_options_run_through_the_pipeline(kw):
    """The options that raised NotImplementedError before the sampler
    extras and block caching were ported now generate through the
    pipeline: images of the right shape, another result than the default
    (block caching on the CPU has no engine: it warns and samples
    exactly, as the JAX generator does)."""
    tr = DiffusionTransformer(_tiny_ltd(), device="cpu")
    base = tr.generate_array_from_text("x", n_iter=3, sampler="ddim")
    if "cache_interval" in kw:
        with pytest.warns(UserWarning, match="exact sampling"):
            got = tr.generate_array_from_text("x", n_iter=3, sampler="ddim", **kw)
        np.testing.assert_array_equal(got, base)
        return
    got = tr.generate_array_from_text("x", n_iter=3, **{"sampler": "ddim", **kw})
    assert got.shape == base.shape == (1, 32, 32, 3) and got.dtype == np.uint8
    assert not np.array_equal(got, base)


def test_fresh_noise_runs_on_the_generator():
    """fresh_noise raised NotImplementedError before it was ported; it now
    samples, deterministically per seed, and refuses DPM++ as JAX does."""
    tr = DiffusionTransformer(_tiny_ltd(), device="cpu")
    labels = np.ones((2, 768), np.float32)
    kw = dict(n_iter=3, num_imgs=2, img_size=16, seed=4, sampler="ddim")
    _, a = tr.diffuser.generate(labels, fresh_noise=True, **kw)
    _, b = tr.diffuser.generate(labels, fresh_noise=True, **kw)
    _, ddim = tr.diffuser.generate(labels, **kw)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert torch.isfinite(a).all() and not torch.equal(a, ddim)
    with pytest.raises(ValueError, match="use_ddpm_plus"):
        tr.diffuser.generate(labels, n_iter=3, num_imgs=2, img_size=16,
                             fresh_noise=True)
