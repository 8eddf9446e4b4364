"""The port's image editing against the JAX package's, on the same weights
and the same noise: img2img, inpainting, a widened model's context, the
zero-init widening, the editing `ValueError`s, `pool_mask_to_latent` and
`slerp`, the four `DiffusionTransformer` entry points, the outpaint
fine-tune's loss and `train.main`, and the WSGI editing requests. Mirrors
tests/test_img2img.py and tests/test_outpaint.py at a 2-layer d = 64
denoiser (8 x 8 latents) and the tiny towers.

Tolerances: float32 on both sides, summed in other orders, so the final
latents agree to rel-L2 1e-4 (measured ~1e-6) and the uint8 images to one
step (a value at a rounding edge); the keep region of inpainting is
bit-equal to the init latents."""

import base64
import io
import json
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from transformer_latent_diffusion_tpu.configs import ClipConfig as JaxClipConfig
from transformer_latent_diffusion_tpu.configs import DenoiserConfig as JaxDenoiserConfig
from transformer_latent_diffusion_tpu.configs import LTDConfig as JaxLTDConfig
from transformer_latent_diffusion_tpu.configs import TrainConfig as JaxTrainConfig
from transformer_latent_diffusion_tpu.configs import VaeConfig as JaxVaeConfig
from transformer_latent_diffusion_tpu.models import Denoiser as JaxDenoiser
from transformer_latent_diffusion_tpu.models.denoiser import (
    expand_input_channels as jax_expand_input_channels,
)
from transformer_latent_diffusion_tpu.sampling import diffusion as jd
from transformer_latent_diffusion_tpu.sampling import pipeline as jp
from transformer_latent_diffusion_tpu.train import train as jtrain
from transformer_latent_diffusion_tpu.utils import common as jax_common
from transformer_latent_diffusion_tpu.utils import init_denoiser_params
from transformer_latent_diffusion_tpu.utils.goldens import rel_l2
from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models.denoiser import (
    Denoiser,
    expand_input_channels,
)
from transformer_latent_diffusion_tpu_torch.sampling import diffusion as td
from transformer_latent_diffusion_tpu_torch.sampling import pipeline as tp
from transformer_latent_diffusion_tpu_torch.train import train as ttrain
from transformer_latent_diffusion_tpu_torch.utils import common

torch.set_num_threads(2)

TINY = dict(image_size=8, embed_dim=64, n_layers=2, noise_embed_dims=64)
JCFG = JaxDenoiserConfig(**TINY)
JWIDE = JaxDenoiserConfig(**TINY, input_channels=8)
S = JCFG.image_size
LAT_REL_L2 = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(jcfg, params, **kw):
    model = Denoiser.from_config(pc.DenoiserConfig(**asdict(jcfg)), **kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.denoiser_state_dict(_np(params), jcfg).items()})
    return model.eval()


def _widened(params, seed=9):
    """The zero-init widening with the new rows then filled at random, so
    the context changes the output."""
    wide = jax_expand_input_channels(params, 4, 8, JCFG.patch_size)
    k = np.array(wide["denoiser_trans_block"]["patch_proj"]["kernel"])
    rows = 4 * JCFG.patch_size ** 2
    k[rows:] = np.random.default_rng(seed).standard_normal(k[rows:].shape) * 0.1
    wide["denoiser_trans_block"]["patch_proj"]["kernel"] = jnp.asarray(k)
    return wide


@pytest.fixture(scope="module")
def gens():
    """(JAX generator, port generator) on the same plain and widened
    weights, no VAE."""
    params = init_denoiser_params(JaxDenoiser(**asdict(JCFG)), JCFG)
    wide = _widened(params)
    plain = (jd.DiffusionGenerator(model=JaxDenoiser(**asdict(JCFG)), params=params),
             td.DiffusionGenerator(_port_model(JCFG, params), device="cpu"))
    widened = (jd.DiffusionGenerator(model=JaxDenoiser(**asdict(JWIDE)), params=wide),
               td.DiffusionGenerator(_port_model(JWIDE, wide), device="cpu"))
    return {"plain": plain, "wide": widened, "params": params}


def _inputs(n=2, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.standard_normal((n, 768)).astype(np.float32)
    noise = rng.standard_normal((n, 4, S, S)).astype(np.float32)
    init = rng.standard_normal((n, 4, S, S)).astype(np.float32)
    return labels, noise, init


def _both(pair, **kw):
    """The x0 latents of both generators on the same call."""
    jgen, gen = pair
    _, want = jgen.generate(img_size=S, **kw)
    _, got = gen.generate(img_size=S, **kw)
    return got, np.asarray(want)


def test_img2img_matches_jax_and_the_manual_schedule_slice(gens):
    """generate(init_latents, strength) against JAX on the same noise; in
    the port it equals the loop started by hand from s0 noise +
    (1 - s0) init on the sliced schedule (bit-equal), and one init
    broadcasts over three images."""
    labels, noise, init = _inputs()
    kw = dict(labels=labels, n_iter=6, num_imgs=2, seeds=noise, sharp_f=0,
              bright_f=0, init_latents=init, strength=0.5)
    got, want = _both(gens["plain"], **kw)
    assert rel_l2(got.numpy(), want) < LAT_REL_L2

    gen = gens["plain"][1]
    full = td.make_noise_levels(6, 1.0)
    n_skip = int(round(0.5 * (len(full) - 1)))
    tail = full[n_skip:]
    x_t = float(tail[0]) * torch.from_numpy(noise) + (1.0 - float(tail[0])) * torch.from_numpy(init)
    _, manual = gen.generate(labels=labels, num_imgs=2, img_size=S, sharp_f=0, bright_f=0,
                             seeds=x_t, noise_levels=tail, clamp_first=False)
    torch.testing.assert_close(got, manual, atol=0, rtol=0)
    plan_kw = {k: v for k, v in kw.items() if k not in ("labels", "sharp_f", "bright_f")}
    assert n_skip > 0 and gen.plan_loop(labels, img_size=S,
                                        **plan_kw).spec.n_steps == len(tail) - 1

    _, three = gen.generate(labels=np.repeat(labels[:1], 3, 0), n_iter=4, num_imgs=3, seed=1,
                            img_size=S, sharp_f=0, bright_f=0, init_latents=init[:1],
                            strength=0.6)
    assert three.shape == (3, 4, S, S) and not torch.equal(three[0], three[1])


def test_inpainting_matches_jax_and_keeps_the_region_exactly(gens):
    """A half mask with sharp/bright shifts (DPM++) against JAX; the keep
    region bit-equal to init on both sides; a mask of ones is img2img
    (bit-equal in the port); a 2-D mask is its (1, 1, S, S) reshape."""
    labels, noise, init = _inputs()
    mask = np.zeros((1, 1, S, S), np.float32)
    mask[..., : S // 2, :] = 1.0
    kw = dict(labels=labels, n_iter=4, num_imgs=2, seeds=noise, init_latents=init,
              sharp_f=0.2, bright_f=-0.1)
    got, want = _both(gens["plain"], mask=mask, **kw)
    assert rel_l2(got.numpy(), want) < LAT_REL_L2
    np.testing.assert_array_equal(got.numpy()[..., S // 2:, :], init[..., S // 2:, :])
    np.testing.assert_array_equal(want[..., S // 2:, :], init[..., S // 2:, :])
    assert not np.allclose(got.numpy()[..., : S // 2, :], init[..., : S // 2, :])

    gen = gens["plain"][1]
    plain_kw = {**kw, "sharp_f": 0, "bright_f": 0, "strength": 0.8}
    _, img2img = gen.generate(img_size=S, **plain_kw)
    _, ones = gen.generate(img_size=S, mask=np.ones((1, 1, S, S)), **plain_kw)
    torch.testing.assert_close(ones, img2img, atol=0, rtol=0)
    _, flat = gen.generate(img_size=S, mask=mask[0, 0], **kw)
    torch.testing.assert_close(flat, got, atol=0, rtol=0)
    plan = gen.plan_loop(labels, n_iter=4, num_imgs=2, seeds=noise, init_latents=init,
                         mask=mask, cache_interval=3, img_size=S)
    assert plan.spec.masked and plan.spec.cache_interval == 1
    assert set(plan.inputs) >= {"mask", "init", "eps"}


def test_context_defaults_to_zeros_and_reaches_the_model(gens):
    """A widened model: no context equals a zero context (bit-equal); a
    context changes the result and matches JAX's on the same context."""
    labels, noise, init = _inputs(1)
    kw = dict(labels=labels, n_iter=4, num_imgs=1, seeds=noise, sharp_f=0, bright_f=0)
    gen = gens["wide"][1]
    _, base = gen.generate(img_size=S, **kw)
    _, zeros = gen.generate(img_size=S, context_latents=np.zeros((1, 4, S, S)), **kw)
    torch.testing.assert_close(base, zeros, atol=0, rtol=0)
    got, want = _both(gens["wide"], context_latents=init, **kw)
    assert rel_l2(got.numpy(), want) < LAT_REL_L2
    assert (got - base).abs().max() > 1e-6
    assert gen.plan_loop(labels, context_latents=init, img_size=S, n_iter=4,
                         num_imgs=1).spec.context_channels == 4


def test_expand_input_channels_is_exact_and_validates(gens):
    """The port's widening of the converted state_dict equals the
    conversion of JAX's widened tree, and the widened model's output equals
    the original's for any context: exactly on the CPU in float32 (the
    appended K rows multiply zeros); the same ValueError texts."""
    params = gens["params"]
    sd = {k: torch.from_numpy(v) for k, v in convert.denoiser_state_dict(_np(params), JCFG).items()}
    wide_sd = expand_input_channels(sd, 4, 8, JCFG.patch_size)
    want = convert.denoiser_state_dict(
        _np(jax_expand_input_channels(params, 4, 8, JCFG.patch_size)), JWIDE)
    assert set(wide_sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(wide_sd[k].numpy(), v)
    assert sd["denoiser_trans_block.patchify_and_embed.0.weight"].shape[1] == 4
    base = _port_model(JCFG, params)
    wide = Denoiser.from_config(pc.DenoiserConfig(**asdict(JWIDE))).eval()
    wide.load_state_dict(wide_sd)
    rng = np.random.default_rng(2)
    x, ctx = (torch.from_numpy(rng.standard_normal((2, 4, S, S)).astype(np.float32))
              for _ in range(2))
    level = torch.tensor([[0.3], [0.8]])
    label = torch.from_numpy(rng.standard_normal((2, 768)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(wide(torch.cat([x, 3 * ctx], 1), level, label),
                                   base(x, level, label), atol=0, rtol=0)
    for args, text in (((4, 2), "shrink"), ((8, 16), "input rows")):
        with pytest.raises(ValueError) as err:
            expand_input_channels(sd, *args, JCFG.patch_size)
        with pytest.raises(ValueError) as jerr:
            jax_expand_input_channels(params, *args, JCFG.patch_size)
        assert text in str(err.value) and str(err.value) == str(jerr.value)


@pytest.mark.parametrize("which,bad", [
    ("plain", dict(init_latents=np.zeros((1, 4, S, S)), strength=0.0)),
    ("plain", dict(init_latents=np.zeros((1, 4, S, S)), strength=1.5)),
    ("plain", dict(mask=np.ones((1, 1, S, S)))),
    ("plain", dict(context_latents=np.zeros((1, 4, S, S)))),
    ("plain", dict(init_latents=np.zeros((1, 4, S, S)), mask=np.ones((S, S)),
                   fresh_noise=True, sampler="ddim")),
], ids=["strength_zero", "strength_above_one", "mask_without_init", "context_plain",
        "mask_fresh"])
def test_editing_value_errors_match_jax(gens, which, bad):
    """Each editing ValueError of the JAX generator, with its text."""
    kw = dict(labels=np.ones((1, 768), np.float32), num_imgs=1, img_size=S, n_iter=4)
    texts = []
    for gen in gens[which]:
        with pytest.raises(ValueError) as err:
            gen.generate(**kw, **bad)
        texts.append(str(err.value))
    assert texts[0] == texts[1]


def test_pool_mask_to_latent_and_slerp_match_jax():
    """Both numpy on both sides: exact."""
    rng = np.random.default_rng(5)
    for mask in (rng.integers(0, 2, (16, 16)) * 255, rng.integers(0, 3, (16, 16, 4)),
                 rng.uniform(-1, 1, (8, 8))):
        np.testing.assert_array_equal(tp.pool_mask_to_latent(mask, 8),
                                      jp.pool_mask_to_latent(mask, 8))
    for mask in (np.ones((16, 8)), np.ones((12, 12))):
        with pytest.raises(ValueError) as err:
            tp.pool_mask_to_latent(mask, 8)
        assert str(err.value) == str(pytest.raises(
            ValueError, jp.pool_mask_to_latent, mask, 8).value)
    a, b = rng.standard_normal((2, 768)).astype(np.float32)
    for t in (np.linspace(0, 1, 5), 0.3):
        np.testing.assert_array_equal(common.slerp(a, b, t), jax_common.slerp(a, b, t))
    np.testing.assert_array_equal(common.slerp(a, a, 0.5), jax_common.slerp(a, a, 0.5))


# ------------------------------ the pipeline ------------------------------


def _ltd(package, denoiser_cfg):
    vae = package.VaeConfig(block_out_channels=(8, 16), layers_per_block=1)
    clip = package.ClipConfig(width=64, heads=2, layers=2)
    return package.LTDConfig(denoiser_cfg=denoiser_cfg, vae_cfg=vae, clip_cfg=clip,
                             use_pallas=False)


class _JaxPackage:
    VaeConfig, ClipConfig, LTDConfig = JaxVaeConfig, JaxClipConfig, JaxLTDConfig


def _fixed_noise(seeds, num_imgs, img_size, seed):
    """The JAX generator's `initialize_image`: a numpy draw per seed."""
    if seeds is not None:
        return seeds
    return np.random.default_rng(seed).standard_normal(
        (num_imgs, 4, img_size, img_size)).astype(np.float32)


def _fixed_noise_port(seeds, num_imgs, img_size, seed):
    """The port generator's: the same draw, as a tensor."""
    return td._as_f32(_fixed_noise(seeds, num_imgs, img_size, seed), "cpu")


@pytest.fixture(scope="module")
def pipes():
    """A JAX and a port DiffusionTransformer on the same tower weights,
    both generators' initial noise from `_fixed_noise`, the port's VAE
    encode fed the JAX draw; `wide(...)` swaps a widened model in."""
    jpipe = jp.DiffusionTransformer(_ltd(_JaxPackage, JCFG))
    tr = tp.DiffusionTransformer(_ltd(pc, pc.DenoiserConfig(**TINY)), device="cpu")
    tr.vae.load_state_dict({k: torch.from_numpy(v) for k, v in
                            convert.vae_state_dict(_np(jpipe.vae.params)).items()})
    tr.clip_model.load_state_dict({k: torch.from_numpy(v) for k, v in
                                   convert.clip_text_state_dict(
                                       _np(jpipe.clip_model.params)).items()})
    encode = tr.vae.encode

    def jax_eps_encode(img):
        b, _, h, w = img.shape
        eps = jax.random.normal(jax.random.PRNGKey(0), (b, h // 2, w // 2, 4), jnp.float32)
        return encode(img, eps=torch.from_numpy(np.array(eps).transpose(0, 3, 1, 2)))

    tr.vae.encode = jax_eps_encode

    def use(jmodel_cfg, params):
        jpipe.diffuser = jd.DiffusionGenerator(
            model=JaxDenoiser(**asdict(jmodel_cfg)), params=params, vae=jpipe.vae)
        tr.diffuser = td.DiffusionGenerator(_port_model(jmodel_cfg, params),
                                            vae=tr.vae, device="cpu")
        jpipe.diffuser.initialize_image = _fixed_noise
        tr.diffuser.initialize_image = _fixed_noise_port

    use(JCFG, jpipe.diffuser.params)
    return jpipe, tr, use


def _image(px=2 * S, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (px, px, 3), dtype=np.uint8)


def _same_pixels(got, want):
    got, want = np.asarray(got).astype(int), np.asarray(want).astype(int)
    assert got.shape == want.shape and np.abs(got - want).max() <= 1


def test_pipeline_image_to_image_and_inpaint_match_jax(pipes):
    """image_to_image and inpaint (an image-space mask) against JAX's on
    the same weights and noise: the same grid to one step; the wrong-size
    and non-square images raise JAX's text; pad_to returns num_imgs."""
    jpipe, tr, _ = pipes
    src = _image()
    kw = dict(strength=0.5, n_iter=3, seed=5, num_imgs=2)
    _same_pixels(tr.image_to_image(src, "a cute cat", **kw),
                 jpipe.image_to_image(src, "a cute cat", **kw))
    mask = np.zeros((2 * S, 2 * S), np.uint8)
    mask[: S] = 255
    got = tr.inpaint(src, mask, "a cute cat", n_iter=3, seed=5)
    _same_pixels(got, jpipe.inpaint(src, mask, "a cute cat", n_iter=3, seed=5))
    assert got.size == (2 * S + 8, 2 * S + 8)
    padded = tr.image_to_image(np.stack([src, _image(seed=1), _image(seed=2)]), "x",
                               n_iter=3, pad_to=4)
    assert padded.size == (2 * S + 8, 4 + 3 * (2 * S + 4))  # three, one a row
    for wrong in (np.zeros((4 * S, 4 * S, 3), np.uint8), np.zeros((4 * S, 2 * S, 3), np.uint8)):
        with pytest.raises(ValueError) as err:
            tr.image_to_image(wrong, "x", n_iter=3)
        assert "resize" in str(err.value) and str(err.value) == str(
            pytest.raises(ValueError, jpipe.image_to_image, wrong, "x", n_iter=3).value)


def test_pipeline_interpolate_matches_jax(pipes):
    """interpolate with prompt_b and seed_b (both axes), then seed_b only,
    against JAX's; the frame count and its checks."""
    jpipe, tr, _ = pipes
    for kw in (dict(prompt_b="a red car", seed_b=4), dict(seed_b=4)):
        got = tr.interpolate("a cute cat", n_frames=3, n_iter=3, **kw)
        _same_pixels(got, jpipe.interpolate("a cute cat", n_frames=3, n_iter=3, **kw))
        assert got.size == (4 + 3 * (2 * S + 4), 2 * S + 8)
    for kw, text in ((dict(n_frames=1, seed_b=2), "n_frames"), ({}, "nothing to interpolate")):
        with pytest.raises(ValueError, match=text):
            tr.interpolate("x", **kw)


def test_pipeline_outpaint_matches_jax(pipes):
    """outpaint with a widened model, 2 tiles to the right, against JAX's
    panorama; the input's pixels kept; left and down sizes; a plain model
    refused with JAX's text."""
    jpipe, tr, use = pipes
    src = _image()
    with pytest.raises(ValueError) as err:
        tr.outpaint(src, "x", n_iter=3)
    assert "widened-input" in str(err.value) and str(err.value) == str(
        pytest.raises(ValueError, jpipe.outpaint, src, "x", n_iter=3).value)
    use(JWIDE, _widened(jpipe.diffuser.params))
    try:
        pan = tr.outpaint(src, "a field", n_tiles=2, overlap=0.5, n_iter=3)
        _same_pixels(pan, jpipe.outpaint(src, "a field", n_tiles=2, overlap=0.5, n_iter=3))
        px = 2 * S
        assert pan.size == (px + 2 * (px // 2), px)
        np.testing.assert_array_equal(np.asarray(pan)[:, :px], src)
        left = tr.outpaint(src, "a field", direction="left", n_iter=3)
        np.testing.assert_array_equal(np.asarray(left)[:, -px:], src)
        assert tr.outpaint(src, "a field", direction="down", overlap=0.25,
                           n_iter=3).size == (px, px + 3 * px // 4)
    finally:
        use(JCFG, init_denoiser_params(JaxDenoiser(**asdict(JCFG)), JCFG))


# ------------------------------ the outpaint fine-tune ------------------------------


def _jax_outpaint_draws(rng, x, train_cfg):
    """The JAX loss's draws for `rng` (train.py:357-397), and its context
    mask as `_outpaint_context` builds it from r_ctx (train.py:305-330)."""
    n, _, h, w = x.shape
    r_beta, r_noise, r_drop, _, r_ctx = jax.random.split(rng, 5)
    draws = {
        "noise_level": jtrain.sample_beta(r_beta, train_cfg.beta_a, train_cfg.beta_b, (n, 1)),
        "noise": jax.random.normal(r_noise, x.shape, dtype=jnp.float32),
        "keep": jax.random.uniform(r_drop, (n, 1)) >= 0.15}
    r_side, r_frac, r_zero = jax.random.split(r_ctx, 3)
    side = np.asarray(jax.random.randint(r_side, (n,), 0, 4))
    frac = np.asarray(jax.random.uniform(r_frac, (n, 1), minval=0.25, maxval=0.75))
    zero = np.asarray(jax.random.uniform(r_zero, (n,)) < 0.1)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    draws["context_mask"] = ttrain.outpaint_context_mask(
        *(torch.from_numpy(np.array(v)) for v in (side, frac, zero)), h, w)
    return draws


def test_outpaint_loss_matches_jax_on_jax_draws():
    """The outpaint loss of a widened tiny model on JAX's draws, the
    context mask included: the loss to 1e-5 relative and every gradient
    to rel-L2 1e-4 (float32; the port's fused layer on its CPU route
    against JAX's linen blocks)."""
    params = _widened(init_denoiser_params(JaxDenoiser(**asdict(JCFG)), JCFG))
    jmodel = JaxDenoiser(**asdict(JWIDE))
    rng_np = np.random.default_rng(7)
    x = rng_np.standard_normal((8, 4, S, S)).astype(np.float32)
    y = rng_np.standard_normal((8, 768)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    jtc = JaxTrainConfig(outpaint=True)
    jloss, jgrads = jax.jit(jax.value_and_grad(jtrain.build_loss_fn(jmodel, jtc, 8.0)))(
        params, jnp.asarray(x), jnp.asarray(y), rng)
    model = _port_model(JWIDE, params, fused_layer_vjp=True)
    loss_fn = ttrain.build_loss_fn(model, pc.TrainConfig(outpaint=True), 8.0)
    draws = _jax_outpaint_draws(rng, x, jtc)
    m = draws["context_mask"]
    assert m.shape == (8, 1, S, S) and 0 < float(m.mean()) < 1
    loss = loss_fn.loss_from_draws(model, torch.from_numpy(x), torch.from_numpy(y), **draws)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    # JAX's gradient tree in the port's layout (the JAX converter takes no
    # widened patch projection)
    want = convert.denoiser_state_dict(_np(jgrads), JWIDE)
    for name, p in model.named_parameters():
        assert rel_l2(p.grad.numpy(), want[name]) < 1e-4, name
    own = loss_fn.sample_draws(torch.Generator().manual_seed(0), torch.zeros(64, 4, S, S))
    share = own["context_mask"].mean((1, 2, 3))
    assert own["context_mask"].shape == (64, 1, S, S) and 0 < float((share == 0).float().mean()) < 0.3
    assert float(share.max()) <= 0.75 and float(share[share > 0].min()) >= 0.25


def test_outpaint_fine_tune_trains_and_validates(tmp_path):
    """train.main with outpaint=True from a widened state_dict: 2 epochs,
    finite losses, an eval grid with zero context; the JAX package's
    input_channels checks, with their texts."""
    from tests.test_torch_port_training import _cfg

    base = Denoiser.from_config(pc.DenoiserConfig(**TINY))
    common.init_random_weights_(base, 0)
    wide_sd = expand_input_channels(base.state_dict(), 4, 8, 2)
    cfg = _cfg(tmp_path, outpaint=True, save_and_eval_every_iters=1000)
    cfg.denoiser_config = replace(cfg.denoiser_config, input_channels=8)
    r = ttrain.main(cfg, device="cpu", init_state_dict=wide_sd)
    assert r["global_step"] == 4 and all(np.isfinite(r["losses"]))
    assert (tmp_path / "ckpts" / "model" / "eval" / "img.jpg").exists()
    with pytest.raises(ValueError, match="input_channels"):
        ttrain.main(_cfg(tmp_path, outpaint=True), device="cpu")
    bad = _cfg(tmp_path)
    bad.denoiser_config = replace(bad.denoiser_config, input_channels=8)
    with pytest.raises(ValueError, match="outpaint=False"):
        ttrain.main(bad, device="cpu")


# ------------------------------ the service ------------------------------


def _b64(arr, fmt="PNG"):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return base64.b64encode(buf.getvalue()).decode()


def _post(app, body, token="test-token"):
    raw = json.dumps(body).encode()
    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/generate-image/",
               "CONTENT_LENGTH": str(len(raw)), "wsgi.input": io.BytesIO(raw),
               "HTTP_AUTHORIZATION": f"Bearer {token}"}
    seen = {}

    def start_response(status, headers):
        seen["status"] = int(status.split()[0])

    out = b"".join(app(environ, start_response))
    return seen["status"], out


@pytest.fixture(scope="module")
def service_app():
    from transformer_latent_diffusion_tpu_torch.serve.app import create_wsgi_app

    return create_wsgi_app(_ltd(pc, pc.DenoiserConfig(**TINY)), device="cpu")


def test_wsgi_editing_requests(service_app, monkeypatch):
    """init_image (PNG, and JPEG with a mask), interpolate_to and seed_b
    answer a JPEG of the right size; the JAX service's 422s answer with
    its texts (checked against the JAX WSGI app, which answers them
    before any generation)."""
    from tests.test_torch_port_serve import _FailingService
    from transformer_latent_diffusion_tpu.serve.app import create_wsgi_app as jax_app
    from transformer_latent_diffusion_tpu_torch.serve.app import create_wsgi_app

    monkeypatch.setenv("API_TOKEN", "test-token")
    src = _image()
    mask = np.zeros((2 * S, 2 * S), np.uint8)
    mask[S:] = 255
    for body, size in (
            ({"init_image": _b64(src)}, 2 * S + 8),
            ({"init_image": _b64(src, "JPEG"), "mask": _b64(mask), "num_imgs": 4},
             2 * (2 * S + 4) + 4),
            ({"interpolate_to": "a dog"}, None),
            ({"seed_b": 5, "num_imgs": 3}, None)):
        status, out = _post(service_app, {"prompt": "a cat", "n_iter": 3, **body})
        assert status == 200 and out[:3] == b"\xff\xd8\xff", out[:200]
        w, h = Image.open(io.BytesIO(out)).size
        frames = max(body.get("num_imgs", 1), 2)
        assert (w, h) == ((size, size) if size else (4 + frames * (2 * S + 4), 2 * S + 8))
    with pytest.warns(UserWarning, match="sampling exactly"):
        assert _post(service_app, {"prompt": "x", "n_iter": 3, "cache_interval": 2,
                                   "init_image": _b64(src)})[0] == 200
    ours, theirs = (create_wsgi_app(service=_FailingService()),
                    jax_app(service=_FailingService()))
    for body in ({"mask": "abc"}, {"strength": 0.3}, {"init_image": "abc", "seed_b": 3},
                 {"init_image": "abc", "interpolate_to": "y"},
                 {"seed_b": 2, "sampler": "ddim"}, {"interpolate_to": "y", "eta": 0.5}):
        got = _post(ours, {"prompt": "x", **body})
        assert got[0] == 422 and got == _post(theirs, {"prompt": "x", **body}), (body, got)
