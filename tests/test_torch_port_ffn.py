"""The port's other FFNs against the JAX package's on the CPU: `MLP` and
the Switch `MoEMLP` (routing, capacity drops, the load-balancing loss and
the per-expert load), tiny MLP and MoE denoisers through `convert.py`
(forward, and the training loss with every gradient on the JAX draws, the
attention pair through K6 on both sides), `train.main` one step for each
FFN, a text-to-image request for each against the JAX sampler, and the
gates that keep both FFNs off the sep-conv engines. Mirrors
tests/test_moe.py."""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.configs import DenoiserConfig as JaxDenoiserConfig
from transformer_latent_diffusion_tpu.configs import TrainConfig as JaxTrainConfig
from transformer_latent_diffusion_tpu.models import Denoiser as JaxDenoiser
from transformer_latent_diffusion_tpu.models.blocks import MLP as JaxMLP
from transformer_latent_diffusion_tpu.models.clip import FlaxClip
from transformer_latent_diffusion_tpu.models.moe import MoEMLP as JaxMoEMLP
from transformer_latent_diffusion_tpu.models.vae import FlaxVae
from transformer_latent_diffusion_tpu.sampling import diffusion as jd
from transformer_latent_diffusion_tpu.train import train as jtrain
from transformer_latent_diffusion_tpu.utils import init_denoiser_params
from transformer_latent_diffusion_tpu.utils.goldens import rel_l2
from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models.blocks import MLP
from transformer_latent_diffusion_tpu_torch.models.clip import ClipTextModel
from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
from transformer_latent_diffusion_tpu_torch.models.moe import MoEMLP, expert_capacity
from transformer_latent_diffusion_tpu_torch.models.vae import VaeDecoder
from transformer_latent_diffusion_tpu_torch.sampling import diffusion as td
from transformer_latent_diffusion_tpu_torch.sampling.pipeline import (
    DiffusionTransformer,
    uses_fused_engine,
)
from transformer_latent_diffusion_tpu_torch.train import train as ttrain
from transformer_latent_diffusion_tpu_torch.utils.common import init_random_weights_

torch.set_num_threads(2)

TINY = dict(image_size=8, embed_dim=64, n_layers=2, noise_embed_dims=64)
FFNS = ("mlp", "moe")


def _np(t):
    return t.detach().float().numpy()


def _tokens(b=2, s=16, d=32, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    return module


def test_mlp_matches_jax_module():
    """Linear -> exact GELU -> Linear: the output and the input's and
    every parameter's gradient within 1e-5 of the JAX MLP's (float32)."""
    x = _tokens()
    jm = JaxMLP(embed_dim=32, mlp_multiplier=2, dropout_level=0.0)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    g = _tokens(seed=1)
    out, vjp = jax.vjp(jax.jit(lambda p, xx: jm.apply({"params": p}, xx)), params,
                       jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    m = _load(MLP(32, 2), _ffn_state_dict(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = m(xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(got), np.asarray(out), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx), atol=1e-5, rtol=1e-5)
    for i, name in ((0, "Dense_0"), (2, "Dense_1")):
        lin = m.mlp[i]
        np.testing.assert_allclose(_np(lin.weight.grad).T, np.asarray(gp[name]["kernel"]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(lin.bias.grad), np.asarray(gp[name]["bias"]),
                                   atol=1e-5, rtol=1e-5)


def _ffn_state_dict(params):
    """A JAX FFN module's params as the port module's state_dict, through
    convert.decoder_block_state_dict (the block's other leaves zeros)."""
    z, v = np.zeros((1, 1), np.float32), np.zeros(1, np.float32)
    blk = {"mlp": jax.tree.map(np.asarray, params),
           "self_attention": {"qkv_linear": {"kernel": z}},
           "cross_attention": {"q_linear": {"kernel": z}, "kv_linear": {"kernel": z}},
           **{n: {"scale": v, "bias": v} for n in ("norm1", "norm2", "norm3")}}
    return {k[len("mlp."):]: w for k, w in convert.decoder_block_state_dict(blk).items()
            if k.startswith("mlp.")}


@pytest.mark.parametrize("e,cf", [(4, 1.25), (4, 0.5), (1, 0.25)])
def test_moe_matches_jax_module(e, cf):
    """float32 MoEMLP against the JAX module on the same weights: the same
    expert for every token (asserted first: a near-tie could route a
    token differently), the output within 1e-5 (tokens past capacity
    exactly 0), the Switch loss E sum f_e p_e and the load f_e within
    1e-6, and the gradients of x and every parameter within 1e-5, for
    ample capacity, capacity 0.5 (drops) and one expert at 0.25 (12 of 16
    tokens dropped, as tests/test_moe.py)."""
    x = _tokens(seed=e)
    jm = JaxMoEMLP(embed_dim=32, mlp_multiplier=2, dropout_level=0.0, n_experts=e,
                   capacity_factor=cf)
    params = jm.init(jax.random.PRNGKey(e), jnp.asarray(x))["params"]
    m = _load(MoEMLP(32, 2, n_experts=e, capacity_factor=cf), _ffn_state_dict(params))
    want_idx = np.argmax(x @ np.asarray(params["router"]["kernel"]), -1)
    _, dispatch, _, mask = m.route(torch.from_numpy(x))
    np.testing.assert_array_equal(mask.argmax(-1).numpy(), want_idx)

    g = _tokens(seed=e + 10)

    def f(p, xx):
        out, mut = jm.apply({"params": p}, xx, mutable=["losses", "moe_metrics"])
        return out, (mut["losses"]["moe_aux"][0], mut["moe_metrics"]["load"][0])

    out, vjp, (aux, load) = jax.vjp(jax.jit(f), params, jnp.asarray(x), has_aux=True)
    gp, gx = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = m(xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(got), np.asarray(out), atol=1e-5, rtol=1e-5)
    c = expert_capacity(16, e, cf)
    kept = dispatch.sum((2, 3)).bool()
    assert int(kept.sum()) == sum(min(c, int((want_idx[b] == j).sum()))
                                  for b in range(2) for j in range(e))
    assert np.all(_np(got)[~kept.numpy()] == 0.0)
    np.testing.assert_allclose(float(m.aux_loss.detach()), float(aux), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(m.load.numpy(), np.asarray(load), atol=1e-6)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(m.router.weight.grad).T,
                               np.asarray(gp["router"]["kernel"]), atol=1e-5, rtol=1e-5)
    for name in ("wi", "bi", "wo", "bo"):
        np.testing.assert_allclose(_np(getattr(m, name).grad), np.asarray(gp[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_moe_random_weights_follow_fan_in():
    """init_random_weights_ on a MoE block: the expert biases zero, the
    expert weights normal with std 1/sqrt(fan_in) of their middle axis."""
    m = init_random_weights_(MoEMLP(64, 4, n_experts=8), 0).requires_grad_(False)
    assert not m.bi.any() and not m.bo.any()
    assert abs(float(m.wi.std()) * 64 ** 0.5 - 1) < 0.02
    assert abs(float(m.wo.std()) * 256 ** 0.5 - 1) < 0.02


# ------------------------------ the denoisers ------------------------------


def _jax_draws(rng, n, shape, train_cfg):
    r_beta, r_noise, r_drop, _, _ = jax.random.split(rng, 5)
    nl = jtrain.sample_beta(r_beta, train_cfg.beta_a, train_cfg.beta_b, (n, 1))
    noise = jax.random.normal(r_noise, shape, dtype=jnp.float32)
    keep = jax.random.uniform(r_drop, (n, 1)) >= 0.15
    return {"noise_level": torch.from_numpy(np.array(nl)),
            "noise": torch.from_numpy(np.array(noise)),
            "keep": torch.from_numpy(np.array(keep))}


def _denoisers(mlp_class, **flags):
    jcfg = JaxDenoiserConfig(**TINY, mlp_class=mlp_class, n_experts=4)
    jmodel = JaxDenoiser(**asdict(jcfg), **flags)
    params = init_denoiser_params(jmodel, jcfg)
    model = Denoiser.from_config(pc.DenoiserConfig(**asdict(jcfg)), **flags)
    _load(model, convert.denoiser_state_dict(jax.tree.map(np.asarray, params), jcfg))
    return jcfg, jmodel, params, model


@pytest.mark.parametrize("mlp_class", FFNS)
def test_denoiser_loss_and_grads_match_jax(mlp_class):
    """A tiny MLP or MoE Denoiser with fused_layer_vjp=True on both sides
    (the attention pair through K6: interpret mode in JAX, the plain
    version here), the same weights through convert.py, the same batch
    and the JAX draws: the training loss, a forward of the whole denoiser
    (with moe_aux_weight times the Switch loss for the MoE), to 1e-5
    relative and every gradient leaf within rel-L2 1e-4 (float32; a token
    routed to another expert would move both far more)."""
    jcfg, jmodel, params, model = _denoisers(mlp_class, fused_layer_vjp=True)
    rng_np = np.random.default_rng(7)
    x = rng_np.standard_normal((4, 4, 8, 8)).astype(np.float32)
    y = rng_np.standard_normal((4, 768)).astype(np.float32)
    jtc = JaxTrainConfig(moe_aux_weight=0.5)
    rng = jax.random.PRNGKey(3)
    jloss, jgrads = jax.jit(jax.value_and_grad(jtrain.build_loss_fn(jmodel, jtc, 8.0)))(
        params, jnp.asarray(x), jnp.asarray(y), rng)
    loss_fn = ttrain.build_loss_fn(model, pc.TrainConfig(moe_aux_weight=0.5), 8.0)
    loss = loss_fn.loss_from_draws(model, torch.from_numpy(x), torch.from_numpy(y),
                                   **_jax_draws(rng, 4, x.shape, jtc))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    if mlp_class == "moe":
        aux = float(model.moe_aux_loss().detach())
        assert 2.0 * (1 - 1e-4) <= aux <= 2 * 4.0  # two layers, each in [1, E]
    want = convert.denoiser_state_dict(jax.tree.map(np.asarray, jgrads), jcfg)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) <= set(want)
    for name, gr in grads.items():
        assert rel_l2(_np(gr), want[name]) < 1e-4, name


def _write_data(tmp_path, n=8, img_size=8):
    rng = np.random.default_rng(0)
    paths = [str(tmp_path / f) for f in ("latents.npy", "text_emb.npy", "val_emb.npy")]
    np.save(paths[0], rng.standard_normal((n, 4, img_size, img_size)).astype(np.float32))
    np.save(paths[1], rng.standard_normal((n, 768)).astype(np.float32))
    np.save(paths[2], rng.standard_normal((8, 768)).astype(np.float32))
    return pc.DataConfig(*paths)


@pytest.mark.parametrize("mlp_class", FFNS)
def test_train_main_one_step_on_cpu(tmp_path, mlp_class):
    """train.main trains an MLP and a MoE denoiser (fused_attn_vjp=True: the
    attention pair through K6's plain version) one step, the MoE loss
    with its Switch term; the EMA model keeps the FFN."""
    cfg = pc.ModelConfig(
        data_config=_write_data(tmp_path),
        denoiser_config=pc.DenoiserConfig(**TINY, mlp_class=mlp_class, n_experts=4),
        train_config=pc.TrainConfig(n_epoch=1, batch_size=8, save_model=False,
                                    save_and_eval_every_iters=10 ** 9,
                                    fused_attn_vjp=True, moe_aux_weight=1.0,
                                    checkpoint_dir=str(tmp_path / "ckpts")),
        vae_cfg=pc.VaeConfig(block_out_channels=(8, 16), layers_per_block=1))
    r = ttrain.main(cfg, device="cpu")
    assert r["global_step"] == 1 and np.isfinite(r["losses"][0])
    blocks = r["model"].denoiser_trans_block.decoder_blocks
    assert all(b.fused_attn_vjp and b.mlp_class == mlp_class for b in blocks)
    assert r["ema_model"].mlp_class == mlp_class
    if mlp_class == "moe":
        assert r["losses"][0] > float(r["model"].moe_aux_loss().detach()) >= 2 * (1 - 1e-4)


def test_fused_flags_follow_jax():
    """resolve_fused_flags gives the JAX package's (layer, mlp, attn) for the
    same knobs, CUDA for the TPU (fused_layer_vjp=False on CUDA raises)."""
    for knobs in (dict(), dict(fused_attn_vjp=True), dict(fused_layer_vjp=True),
                  dict(fused_layer_vjp=True, fused_attn_vjp=False),
                  dict(fused_mlp_vjp=True, fused_attn_vjp=True)):
        for dev in (False, True):
            if dev and knobs.get("fused_layer_vjp", True) is False:
                continue
            want = jtrain.resolve_fused_flags(JaxTrainConfig(**knobs), dev)
            assert ttrain.resolve_fused_flags(pc.TrainConfig(**knobs), dev) == tuple(
                bool(v) for v in want), knobs


# ------------------------------ serving ------------------------------


@pytest.fixture(scope="module")
def towers():
    jclip = FlaxClip.create(width=64, heads=2, layers=2, dtype=jnp.float32)
    jvae = FlaxVae.create(block_out_channels=(8, 16), layers_per_block=1, sample_size=8)
    clip = _load(ClipTextModel(width=64, heads=2, layers=2),
                 convert.clip_text_state_dict(jax.tree.map(np.asarray, jclip.params))).eval()
    vae = _load(VaeDecoder((8, 16), layers_per_block=1),
                convert.vae_decoder_state_dict(jax.tree.map(np.asarray, jvae.params))).eval()
    return jclip, jvae, clip, vae


@pytest.mark.parametrize("mlp_class", FFNS)
def test_text_to_image_matches_jax(towers, mlp_class):
    """Prompt -> CLIP -> 3-step DDIM with CFG 6 -> VAE through an MLP or MoE
    denoiser, each package on its own towers with the same weights and
    initial noise (the doubled CFG batch in the JAX sampler's order):
    float32 latents within rel-L2 1e-4, images within 1 LSB."""
    jclip, jvae, clip, vae = towers
    jcfg, jmodel, params, model = _denoisers(mlp_class)
    noise = np.random.default_rng(3).standard_normal((2, 4, 8, 8)).astype(np.float32)
    kw = dict(n_iter=3, num_imgs=2, class_guidance=6, seeds=noise, img_size=8,
              output="uint8", sampler="ddim")
    prompts = ["a cute cat", "a red car"]
    jimg, jlat = jd.DiffusionGenerator(model=jmodel, params=params, vae=jvae).generate(
        labels=jclip.encode_text(prompts), **kw)
    img, lat = td.DiffusionGenerator(model.eval(), vae=vae, device="cpu").generate(
        labels=clip.encode_text(prompts), **kw)
    assert rel_l2(lat.numpy(), np.asarray(jlat)) < 1e-4
    assert np.abs(img.numpy().astype(int) - np.asarray(jimg).astype(int)).max() <= 1


@pytest.mark.parametrize("mlp_class", FFNS)
def test_pipeline_request_and_engine_gate(mlp_class):
    """A CPU DiffusionTransformer on an MLP or MoE config answers a request
    (uint8 images, the same seed the same pixels); on CUDA neither FFN
    gets a fused engine, with or without quantize, where the sep-conv
    one does (the JAX package's gate, sampling/pipeline.py:225-237)."""
    cfg = pc.LTDConfig(
        denoiser_cfg=pc.DenoiserConfig(mlp_class=mlp_class, n_experts=4),
        vae_cfg=pc.VaeConfig(block_out_channels=(8, 16), layers_per_block=1),
        clip_cfg=pc.ClipConfig(width=64, heads=2, layers=2))
    tr = DiffusionTransformer(cfg, device="cpu")
    a = tr.generate_array_from_text("a cute cat", num_imgs=2, n_iter=3, seed=5)
    assert a.shape == (2, 32, 32, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(
        a, tr.generate_array_from_text("a cute cat", num_imgs=2, n_iter=3, seed=5))
    assert tr.diffuser.fast_apply is None
    sep = pc.LTDConfig()
    for quantize in (None, "int8"):
        assert not uses_fused_engine(pc.LTDConfig(
            denoiser_cfg=cfg.denoiser_cfg, quantize=quantize), "cuda")
        assert uses_fused_engine(pc.LTDConfig(quantize=quantize), "cuda")
    assert not uses_fused_engine(sep, "cpu")
