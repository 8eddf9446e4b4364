"""Hi-res serving in the port against the JAX package: the positional-table
resize and upsample, sampling on grids other than the native one, the
flash-attention route (K3) and the fused sep-conv MLP (K5's forward), the
512 px-style slice as a whole (a tiny model with 16 < hw <= 32), and the
routing between the fused engine and the linen path.

On the CPU the port's wrappers run their kernels' plain versions; the
JAX package runs K3's plain reference `_xla_attention` (its `_pallas_ok`
is false off the TPU) and K5 in Pallas interpret mode. The CUDA kernels
themselves are checked against the plain versions on the card
(tests/test_torch_port_cuda.py, and chip_smoke.py)."""

import re
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.configs import DenoiserConfig
from transformer_latent_diffusion_tpu.models import Denoiser as JaxDenoiser
from transformer_latent_diffusion_tpu.models.clip import FlaxClip
from transformer_latent_diffusion_tpu.models.denoiser import (
    resize_pos_embed as jax_resize_pos_embed,
)
from transformer_latent_diffusion_tpu.models.vae import FlaxVae
from transformer_latent_diffusion_tpu.ops.attention import (
    multi_head_attention as jax_mha,
)
from transformer_latent_diffusion_tpu.ops.fused_mlp_vjp import (
    fused_mlp_sepconv_vjp as jax_fused_mlp,
)
from transformer_latent_diffusion_tpu.sampling import diffusion as jd
from transformer_latent_diffusion_tpu.train.highres import (
    upsample_denoiser_params as jax_upsample,
)
from transformer_latent_diffusion_tpu.utils import init_denoiser_params
from transformer_latent_diffusion_tpu.utils.goldens import rel_l2
from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models import blocks
from transformer_latent_diffusion_tpu_torch.models.clip import ClipTextModel
from transformer_latent_diffusion_tpu_torch.models.denoiser import (
    Denoiser,
    resize_pos_embed,
)
from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import (
    make_fused_apply,
)
from transformer_latent_diffusion_tpu_torch.models.vae import VaeDecoder
from transformer_latent_diffusion_tpu_torch.ops import _build
from transformer_latent_diffusion_tpu_torch.ops import attention as att
from transformer_latent_diffusion_tpu_torch.ops import fused_mlp_vjp as fm
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.sampling import diffusion as td
from transformer_latent_diffusion_tpu_torch.sampling.pipeline import (
    denoiser_kernel_flags,
)
from transformer_latent_diffusion_tpu_torch.train.highres import (
    finetune_highres,
    upsample_denoiser_params,
)

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# a 512 px-style tiny model: a 20 x 20 token grid (16 < hw <= 32)
HIRES = dict(image_size=40, embed_dim=128, n_layers=2)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _port_denoiser(cfg, params, dtype=torch.float32, **flags):
    model = Denoiser.from_config(pc.DenoiserConfig(**asdict(cfg)), dtype=dtype,
                                 **flags)
    sd = convert.denoiser_state_dict(_np_tree(params), cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    """The tiny DenoiserConfig (d=128, 3 layers, 8x8 grid) on both sides."""
    cfg = DenoiserConfig()
    jmodel = JaxDenoiser(**asdict(cfg))
    params = init_denoiser_params(jmodel, cfg)
    return cfg, jmodel, params, _port_denoiser(cfg, params)


@pytest.mark.parametrize("old,new", [(8, 16), (16, 8), (8, 12)])
def test_resize_pos_embed_matches_jax(old, new):
    """Up, down (antialiased) and by a non-integer factor: float32 atol
    1e-5 (measured within 5e-7: the same triangle-kernel weights)."""
    table = np.random.default_rng(old * new).standard_normal(
        (old * old, 32)).astype(np.float32)
    want = np.asarray(jax_resize_pos_embed(jnp.asarray(table), old, new))
    got = resize_pos_embed(torch.from_numpy(table), old, new)
    assert got.shape == (new * new, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_upsample_denoiser_params_matches_jax(tiny):
    """The port's state_dict upsample (16 -> 32 px, 8x8 -> 16x16 tokens)
    against the JAX params upsample through `convert`: the resized table
    to float32 atol 1e-5, every other entry equal; the result loads
    strictly into a Denoiser of the new size."""
    cfg, _, params, model = tiny
    big = DenoiserConfig(**{**asdict(cfg), "image_size": 32})
    want = convert.denoiser_state_dict(
        _np_tree(jax_upsample(params, cfg.image_size, 32, cfg.patch_size)), big)
    got = upsample_denoiser_params(model.state_dict(), cfg.image_size, 32,
                                   cfg.patch_size)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-5, rtol=0,
                                   err_msg=k)
    Denoiser.from_config(pc.DenoiserConfig(**asdict(big))).load_state_dict(got)
    # the fine-tune from it (tests/test_torch_port_highres_train.py) takes
    # its device as a required argument, as train.main does
    with pytest.raises(TypeError, match="device"):
        finetune_highres(None, got, cfg.image_size)


def _generate_both(tiny, size, pos_resize=None):
    cfg, jmodel, params, model = tiny
    rng = np.random.default_rng(size)
    labels = rng.standard_normal((2, cfg.text_emb_size)).astype(np.float32)
    noise = rng.standard_normal((2, 4, size, size)).astype(np.float32)
    kw = dict(labels=labels, n_iter=3, num_imgs=2, class_guidance=6,
              seeds=noise, img_size=size, sampler="ddim")
    jgen = jd.DiffusionGenerator(model=jmodel, params=params,
                                 pos_resize=pos_resize)
    _, want = jgen.generate(**kw)
    _, got = td.DiffusionGenerator(model, device="cpu",
                                   pos_resize=pos_resize).generate(**kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("scale", [2.0, 0.5], ids=["2x", "half"])
def test_generate_on_another_grid_matches_jax(tiny, scale):
    """Sampling at 2x and 1/2 the native grid resizes the positional table
    (the default pos_resize=None) as the JAX generator does: float32
    latents of a 3-step DDIM run with CFG 6 on the same explicit noise to
    rel-L2 1e-4 (summation order only)."""
    got, want = _generate_both(tiny, int(tiny[0].image_size * scale))
    assert got.shape == want.shape
    assert rel_l2(got, want) < 1e-4


def test_generate_legacy_slice_matches_jax(tiny):
    """pos_resize=False keeps the first h*w rows of the table, as JAX's."""
    got, want = _generate_both(tiny, tiny[0].image_size // 2, pos_resize=False)
    assert rel_l2(got, want) < 1e-4


@pytest.mark.parametrize("n", [64, 400, 1024])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_multi_head_attention_matches_jax(n, dtype):
    """use_pallas=True on CPU tensors (the plain version of K3) against the
    JAX function on the CPU (K3's plain reference `_xla_attention`), 2
    heads of 64: float32 atol 1e-5; bf16 max-abs within 0.02 x the
    output's scale (the same float32 softmax and bf16 roundings)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(n)
    q, k, v = (rng.standard_normal((2, n, 128)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_mha(*(jnp.asarray(a, jdt) for a in (q, k, v)), 2,
                              use_pallas=True), np.float32)
    got = att.multi_head_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                   2, use_pallas=True).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


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
    """The JAX layouts in the port's: (out, in) products, float32 biases."""
    def t(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    return (t(x), t(w1.T), t(b1, torch.float32), t(dw), t(dwb, torch.float32),
            t(w2.T), t(b2, torch.float32))


@pytest.mark.parametrize("hw", [20, 32])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_mlp_sepconv_matches_jax_kernel(hw, dtype):
    """`fused_mlp_sepconv` on CPU tensors (its plain version) against the
    JAX Pallas kernel in interpret mode, d = 64, hidden 256: float32 atol
    1e-4 / rtol 1e-3 (summation order and the kernel's erf polynomial);
    bf16 max-abs within 0.02 x the output's scale."""
    jdt, tdt = DTYPES[dtype]
    args = _mlp_inputs(hw)
    x, w1, b1, dw, dwb, w2, b2 = args
    want = np.asarray(jax_fused_mlp(
        jnp.asarray(x, jdt), jnp.asarray(w1, jdt), jnp.asarray(b1),
        jnp.asarray(dw, jdt), jnp.asarray(dwb), jnp.asarray(w2, jdt),
        jnp.asarray(b2), hw, True), np.float32)
    fm.reset_launch_counts()
    got = fm.fused_mlp_sepconv(*_port_mlp_args(*args, tdt), hw)
    assert got.dtype == tdt and fm.LAUNCHES["fused_mlp_sepconv"] == 0
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    else:
        assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


@pytest.fixture(scope="module")
def hires():
    cfg = DenoiserConfig(**HIRES)
    params = init_denoiser_params(JaxDenoiser(**asdict(cfg)), cfg)
    return cfg, params


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_hires_denoiser_matches_jax(hires, dtype):
    """The slice's model: the port's Denoiser(use_pallas=True,
    fused_mlp_vjp=True) against the JAX one on the CPU (K3's plain
    reference, K5 in interpret mode) on a 20 x 20 grid, where both gates
    are open. Bounds of test_plain_denoiser_matches_jax: float32 atol 1e-4
    / rtol 1e-3; bf16 max-abs within 0.03 x the output's scale."""
    cfg, params = hires
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 40, 40)).astype(np.float32)
    nl = rng.uniform(0.01, 0.99, (2, 1)).astype(np.float32)
    label = rng.standard_normal((2, cfg.text_emb_size)).astype(np.float32)
    jmodel = JaxDenoiser(**asdict(cfg), dtype=jdt, use_pallas=True,
                         fused_mlp_vjp=True)
    want = np.asarray(jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a))(
        params, x, nl, label))
    model = _port_denoiser(cfg, params, tdt, use_pallas=True, fused_mlp_vjp=True)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (x, nl, label))).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    else:
        assert np.abs(got - want).max() < 0.03 * np.abs(want).max()


def test_hires_text_to_image_matches_jax(hires):
    """Prompt -> CLIP -> 3-step DDIM with CFG 6 -> VAE -> uint8 on the
    20 x 20-token model with both kernel flags, each side on its own tiny
    towers with the same weights and noise (as
    test_text_to_image_slice_matches_jax): float32 latents to rel-L2 1e-4,
    images to 1 LSB."""
    cfg, params = hires
    jmodel = JaxDenoiser(**asdict(cfg), use_pallas=True, fused_mlp_vjp=True)
    jclip = FlaxClip.create(width=64, heads=2, layers=2, dtype=jnp.float32)
    jvae = FlaxVae.create(block_out_channels=(8, 16), layers_per_block=1,
                          sample_size=8)
    model = _port_denoiser(cfg, params, use_pallas=True, fused_mlp_vjp=True)
    clip = ClipTextModel(width=64, heads=2, layers=2)
    clip.load_state_dict({k: torch.from_numpy(v) for k, v in
                          convert.clip_text_state_dict(_np_tree(jclip.params)).items()})
    vae = VaeDecoder((8, 16), layers_per_block=1)
    vae.load_state_dict({k: torch.from_numpy(v) for k, v in
                         convert.vae_decoder_state_dict(_np_tree(jvae.params)).items()})
    prompts = ["a cute cat", "a red car on a road"]
    noise = np.random.default_rng(7).standard_normal((2, 4, 40, 40)).astype(np.float32)
    kw = dict(n_iter=3, num_imgs=2, class_guidance=6, seeds=noise, img_size=40,
              output="uint8", sampler="ddim")
    jimg, jlat = jd.DiffusionGenerator(model=jmodel, params=params, vae=jvae).generate(
        labels=jclip.encode_text(prompts), **kw)
    img, lat = td.DiffusionGenerator(model, vae=vae.eval(), device="cpu").generate(
        labels=clip.eval().encode_text(prompts), **kw)
    assert img.shape == (2, 80, 80, 3) and img.dtype == torch.uint8
    assert rel_l2(lat.numpy(), np.asarray(jlat)) < 1e-4
    assert np.abs(img.numpy().astype(int) - np.asarray(jimg).astype(int)).max() <= 1


@pytest.mark.parametrize("image_size,device,want", [
    (32, "cuda", (True, False)), (64, "cuda", (True, True)),
    (128, "cuda", (True, False)), (64, "cpu", (True, False))])
def test_pipeline_kernel_flags_follow_jax_gates(image_size, device, want):
    """The pipeline's Denoiser flags: flash attention everywhere, the fused
    MLP only on CUDA for a native grid of 16 < hw <= 32 (512 px)."""
    cfg = pc.LTDConfig(denoiser_cfg=pc.DenoiserConfig(image_size=image_size))
    flags = denoiser_kernel_flags(cfg, device)
    assert (flags["use_pallas"], flags["fused_mlp_vjp"]) == want


class _SpyEngine:
    """Stands in for the fused engine; records its forwards."""

    def __init__(self, cfg):
        self.engine = make_fused_apply(cfg)
        self.calls = 0

    def prepare(self, sd):
        return self.engine.prepare(sd)

    def apply_prepared(self, *args):
        self.calls += 1
        return self.engine.apply_prepared(*args)


@pytest.mark.parametrize("image_size,size,engine", [
    (16, 16, True), (16, 32, False), (16, 8, False), (32, 32, True),
    (64, 64, False)])
def test_engine_only_on_native_grids_of_at_most_256_tokens(image_size, size,
                                                           engine):
    """The generator takes the fused engine (K1) for a native grid of at
    most 16 x 16 tokens, and the Denoiser (with the resized table on
    another grid) otherwise, as the JAX package's gate does."""
    cfg = pc.DenoiserConfig(image_size=image_size, embed_dim=64, n_layers=1)
    model = Denoiser.from_config(cfg).eval()
    spy = _SpyEngine(cfg)
    gen = td.DiffusionGenerator(model, fast_apply=spy, device="cpu")
    assert gen.uses_engine(size) == engine
    overrides = []
    model.register_forward_pre_hook(
        lambda mod, args, kw: overrides.append(kw.get("pos_embed_override")),
        with_kwargs=True)
    _, lat = gen.generate(np.zeros((1, 768), np.float32), n_iter=2, num_imgs=1,
                          img_size=size)
    assert lat.shape == (1, 4, size, size)
    assert spy.calls == (2 if engine else 0)
    assert len(overrides) == (0 if engine else 2)
    if not engine:
        resized = [o is not None for o in overrides]
        assert resized == [size != image_size] * 2


@pytest.mark.parametrize("hw,fused", [(16, True), (20, True), (32, True),
                                      (33, False)])
def test_mlp_takes_k5_on_square_grids_up_to_1024_tokens(monkeypatch, hw, fused):
    """MLPSepConv(fused_vjp=True) calls K5's forward for a square grid of
    at most FUSED_MLP_MAX_TOKENS tokens, the plain modules beyond."""
    calls = []
    real = blocks.fused_mlp_sepconv
    monkeypatch.setattr(blocks, "fused_mlp_sepconv",
                        lambda *a: calls.append(a[-1]) or real(*a))
    mlp = blocks.MLPSepConv(64, 2, fused_vjp=True)
    with torch.no_grad():
        mlp(torch.randn(1, hw * hw, 64))
    assert calls == ([hw] if fused else [])
    assert blocks.FUSED_MLP_MAX_TOKENS == 1024


def test_wrappers_count_no_cpu_launches_and_refuse_other_devices():
    """CPU tensors take the plain versions and count nothing; tensors on a
    device other than CUDA raise instead of falling back."""
    att.reset_launch_counts()
    fm.reset_launch_counts()
    q = torch.randn(1, 16, 128)
    att.flash_attention(q, q, q, 2)
    assert att.LAUNCHES == {name: 0 for name in att.KERNELS}
    with pytest.raises(ValueError, match="CUDA"):
        att.flash_attention(*(q.to("meta") for _ in range(3)), 2)
    args = _port_mlp_args(*_mlp_inputs(4, hidden=128), torch.bfloat16, "meta")
    with pytest.raises(ValueError, match="CUDA"):
        fm.fused_mlp_sepconv(*args, 4)
    assert fm.LAUNCHES == {name: 0 for name in fm.KERNELS}


@pytest.mark.parametrize("hw,dtype,band", [
    (16, torch.bfloat16, 0), (16, torch.float32, 0), (32, torch.bfloat16, 0),
    (40, torch.bfloat16, 0), (41, torch.bfloat16, 8), (28, torch.float32, 0),
    (29, torch.float32, 8), (32, torch.float32, 8), (88, torch.float32, 8),
    (179, torch.bfloat16, 8), (89, torch.float32, None),
    (180, torch.bfloat16, None)])
def test_dwconv_gelu_body_holds_its_slab(hw, dtype, band):
    """The wrapper's gate is what each body holds in a block's 227 KB: the
    whole-grid body up to hw 40 (bf16) / 28 (float32), then bands of 8
    rows with a one-row halo up to hw 179 / 88; beyond that it raises."""
    item = torch.empty((), dtype=dtype).element_size()
    if band is None:
        with pytest.raises(ValueError, match="shared memory"):
            fs.dwconv_gelu_body(hw, dtype)
        return
    assert fs.dwconv_gelu_body(hw, dtype) == band
    rows = hw if band == 0 else band
    assert (rows + 2) * (hw + 2) * fs.DW_CHUNK * item <= fs.SMEM_PER_BLOCK


def test_c_entry_points_match_the_ctypes_signatures():
    """Each `LTD_API` function in csrc/ takes as many arguments as its
    ctypes signature in ops/_build.py passes (the card's compiler cannot
    be asked here; a mismatch would pass garbage)."""
    found = {}
    for src in _build.CSRC.glob("*.cu"):
        for name, args in re.findall(r"LTD_API int (ltd_\w+)\(([^)]*)\)",
                                     src.read_text()):
            found[name] = len(args.split(","))
    assert found == {k: len(v) for k, v in _build.SIGNATURES.items()}
