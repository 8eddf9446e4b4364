"""The float32 linen path, the JAX package's default compute dtype
(`DenoiserLoad.dtype="float32"`) past the fused engine's 16 x 16 tokens:
512 and 1024 px deployments, the "mlp" and "moe" FFNs, a model sampled on
another grid. There the self-attention runs K3's float32 body
(`flash_attention_f32`) and, on a native grid of 16 < hw <= 32, the
sep-conv MLP K5's float32 route (`ln_gemm_f32`, `dwconv_gelu_f32`'s row
band, `ln_gemm_f32`).

- The wrappers' float32 dispatch without a card (the kernels' library and
  the device checks replaced by stand-ins, meta tensors for CUDA ones):
  float32 `flash_attention` calls the float32 entry point and counts it,
  bf16 the bf16 one; float32 `fused_mlp_sepconv` makes exactly its three
  float32 launches; float16 raises. (The float32 gradients, K4's and K5's
  float32 backward bodies, are tests/test_torch_port_float32_hires_train.py.)
- `train.main` with float16 on CUDA raises before it reads any data, and
  float32 trains on the CPU (the plain versions).
- The slice against JAX on a 36 x 36-token grid (the 1024 px analogue: K5
  off past 1024 tokens, as in JAX): prompt -> CLIP -> 3-step DDIM with
  CFG 6 -> VAE -> uint8 on a tiny float32 model with the kernel flags the
  pipeline sets on CUDA, K3 as JAX's `_xla_attention` on the CPU. The
  other float32 cases of the slice are held elsewhere and not repeated
  here: the 20 x 20 grid with K5 on in
  tests/test_torch_port_highres.py (`test_hires_text_to_image_matches_jax`,
  K5 in interpret mode) and the "mlp" and "moe" FFNs in
  tests/test_torch_port_ffn.py (`test_text_to_image_matches_jax`).
The kernels themselves are held against their plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py's [float32-hires-kernels])."""

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
from transformer_latent_diffusion_tpu.utils.goldens import rel_l2
from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models.clip import ClipTextModel
from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
from transformer_latent_diffusion_tpu_torch.models.vae import VaeDecoder
from transformer_latent_diffusion_tpu_torch.ops import attention as att
from transformer_latent_diffusion_tpu_torch.ops import fused_mlp_vjp as fm
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.ops import fused_stack_f32 as f32
from transformer_latent_diffusion_tpu_torch.sampling import diffusion as td
from transformer_latent_diffusion_tpu_torch.sampling.pipeline import denoiser_kernel_flags
from transformer_latent_diffusion_tpu_torch.train import train as ttrain

torch.set_num_threads(2)

# ------------------------------ the wrappers' dispatch ------------------------------


class _RecordingLib:
    """The kernels' library: records each entry point called with its
    arguments, launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name == "ltd_ln_gemm_scratch_rows":  # a size query, no launch
            return lambda *a: 0

        def call(*args):
            self.calls.append((name, args))
            return 0
        return call

    def names(self):
        return [name for name, _ in self.calls]


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors pass for CUDA ones: the wrappers' checks, allocation and
    dispatch run, the library records the entry points."""
    lib = _RecordingLib()
    meta = torch.device("meta")
    monkeypatch.setattr(att, "_cuda_device", lambda t: t.device)
    monkeypatch.setattr(fm, "_require_cuda", lambda name, x: None)
    monkeypatch.setattr(fs, "_on_cuda", lambda name, *ts: meta)
    for mod in (att, fs):
        monkeypatch.setattr(mod, "_stream", lambda dev: None)
        monkeypatch.setattr(mod, "_ptr", lambda t: None)
    for mod in (att, fs, f32):
        monkeypatch.setattr(mod, "load_library", lambda: lib)
    for mod in (att, fm, fs, f32):
        mod.reset_launch_counts()
    yield lib
    for mod in (att, fm, fs, f32):
        mod.reset_launch_counts()


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(*shape, dtype=dtype, device="meta", requires_grad=grad)


def _qkv(dtype, b=2, n=400, heads=2, grad=False):
    """q, k, v as the model passes them: column views of a fused (B, N, 3D)."""
    return _meta(b, n, 3 * 64 * heads, dtype=dtype, grad=grad).chunk(3, dim=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sends_float32_to_its_body(fake_card, dtype):
    dt = getattr(torch, dtype)
    q, k, v = _qkv(dt)
    with torch.no_grad():
        out = att.multi_head_attention(q, k, v, 2, use_pallas=True)
    assert out.shape == (2, 400, 128) and out.dtype == dt
    name = "flash_attention_f32" if dtype == "float32" else "flash_attention"
    assert fake_card.names() == [f"ltd_{name}"]
    assert att.LAUNCHES == {k_: int(k_ == name) for k_ in att.KERNELS}
    # B, Nq, Nk, heads and the three row strides (the fused projection's
    # 3D), after q, k, v, out and lse (null: no gradient)
    assert fake_card.calls[0][1][4:12] == (None, 2, 400, 400, 2, 384, 384, 384)


def _mlp_args(dtype, hw=32, d=128, grad=False):
    hidden = 4 * d
    f = torch.float32
    return (_meta(2, hw * hw, d, dtype=dtype, grad=grad), _meta(hidden, d, dtype=dtype),
            _meta(hidden), _meta(9, hidden, dtype=dtype), _meta(hidden),
            _meta(d, hidden, dtype=dtype), _meta(d, dtype=f))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_takes_its_float32_route(fake_card, dtype):
    """K5's forward at hw = 32: float32 operands make the float32 bodies'
    three launches (the depthwise + GELU on its row-band body, float32
    taps), bf16 ones the bf16 route's two (the band kernel, then the
    contract product)."""
    dt = getattr(torch, dtype)
    with torch.no_grad():
        y = fm.fused_mlp_sepconv(*_mlp_args(dt), 32)
    assert y.shape == (2, 1024, 128) and y.dtype == dt
    if dtype == "float32":
        assert fake_card.names() == ["ltd_ln_gemm_f32", "ltd_dwconv_gelu", "ltd_ln_gemm_f32"]
        dw_args = fake_card.calls[1][1]
        # (.., B, hw, C, float32 h, float32 out, band rows, mode, float32 taps, stream)
        assert dw_args[5:8] == (2, 32, 512) and dw_args[10] == fs.dwconv_gelu_body(32, dt) == 8
        assert dw_args[13] == 1
        assert f32.LAUNCHES == {"ln_gemm_f32": 2, "self_attention_f32": 0,
                                "cross_attention_f32": 0, "dwconv_gelu_f32": 1}
        assert not any(fs.LAUNCHES.values())
    else:
        assert fake_card.names() == ["ltd_mlp_band_fwd", "ltd_ln_gemm"]
        assert fs.LAUNCHES == {"ln_gemm": 1, "self_attention": 0, "cross_attention": 0,
                               "dwconv_gelu": 0}
        assert not any(f32.LAUNCHES.values())
    route = (("fused_mlp_sepconv_f32",) if dtype == "float32"
             else ("fused_mlp_sepconv", "mlp_band_fwd"))
    assert fm.LAUNCHES == {k: int(k in route) for k in fm.KERNELS}


def test_float16_still_raises(fake_card):
    with torch.no_grad():
        with pytest.raises(ValueError, match="all bf16 or all float32"):
            att.flash_attention(*_qkv(torch.float16), 2)
        with pytest.raises(ValueError, match="all bf16 or all float32"):
            fm.fused_mlp_sepconv(*_mlp_args(torch.float16), 32)
        # a float32 x with bf16 weights is no route either
        args = list(_mlp_args(torch.bfloat16))
        args[0] = _meta(2, 1024, 128)
        with pytest.raises(ValueError):
            fm.fused_mlp_sepconv(*args, 32)
    assert fake_card.calls == []


# ------------------------------ training ------------------------------


def _train_cfg(tmp_path, compute_dtype, data=None, image_size=8):
    return pc.ModelConfig(
        data_config=data or pc.DataConfig(*(str(tmp_path / f"absent_{i}.npy") for i in range(3))),
        denoiser_config=pc.DenoiserConfig(image_size=image_size, embed_dim=64, n_layers=2,
                                          noise_embed_dims=64),
        train_config=pc.TrainConfig(n_epoch=1, batch_size=8, save_model=False,
                                    save_and_eval_every_iters=10 ** 9,
                                    compute_dtype=compute_dtype,
                                    checkpoint_dir=str(tmp_path / "ckpts")),
        vae_cfg=pc.VaeConfig(block_out_channels=(8, 16), layers_per_block=1))


@pytest.mark.parametrize("dtype,item", [("float16", "ROADMAP item 4")])
def test_train_main_refuses_other_compute_dtypes_on_cuda(tmp_path, dtype, item):
    """Before the first step, and before any data is read (the data files
    do not exist): float16 at any size. (float32 trains at every size on
    CUDA: tests/test_torch_port_float32_hires_train.py.)"""
    with pytest.raises(NotImplementedError, match=item):
        ttrain.main(_train_cfg(tmp_path, dtype), device="cuda")


def test_train_main_in_float32_on_cpu(tmp_path):
    rng = np.random.default_rng(0)
    paths = [str(tmp_path / f) for f in ("latents.npy", "text_emb.npy", "val_emb.npy")]
    np.save(paths[0], rng.standard_normal((8, 4, 8, 8)).astype(np.float32))
    np.save(paths[1], rng.standard_normal((8, 768)).astype(np.float32))
    np.save(paths[2], rng.standard_normal((8, 768)).astype(np.float32))
    r = ttrain.main(_train_cfg(tmp_path, "float32", pc.DataConfig(*paths)), device="cpu")
    assert r["global_step"] == 1 and np.isfinite(r["losses"][0])
    assert r["model"].dtype == torch.float32


# ------------------------------ the slice against JAX ------------------------------

# the 1024 px analogue: a 36 x 36-token grid, past K5's 1024 tokens
GRID36 = dict(image_size=72, embed_dim=64, n_layers=2, noise_embed_dims=64)


def test_36x36_grid_text_to_image_matches_jax():
    """Prompt -> CLIP -> 3-step DDIM with CFG 6 -> VAE -> uint8 on a tiny
    float32 model of 36 x 36 tokens, each package on its own towers with the
    same weights and noise: the port's Denoiser with the flags the pipeline
    sets on CUDA (flash attention, no fused MLP past 1024 tokens), the JAX
    one with the flags its pipeline sets on the TPU (K3's plain reference
    `_xla_attention` on the CPU). Float32 latents within rel-L2 1e-4,
    images within 1 LSB."""
    cfg = DenoiserConfig(**GRID36)
    flags = denoiser_kernel_flags(pc.LTDConfig(denoiser_cfg=pc.DenoiserConfig(**GRID36)),
                                  "cuda")
    assert flags == {"use_pallas": True, "fused_mlp_vjp": False}
    jmodel = JaxDenoiser(**asdict(cfg), use_pallas=True, fused_mlp_vjp=False)
    params = init_denoiser_params(jmodel, cfg)
    model = Denoiser.from_config(pc.DenoiserConfig(**asdict(cfg)), dtype=torch.float32,
                                 **flags)
    sd = convert.denoiser_state_dict(jax.tree.map(np.asarray, params), cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jclip = FlaxClip.create(width=64, heads=2, layers=2, dtype=jnp.float32)
    jvae = FlaxVae.create(block_out_channels=(8, 16), layers_per_block=1, sample_size=8)
    clip = ClipTextModel(width=64, heads=2, layers=2)
    clip.load_state_dict({k: torch.from_numpy(v) for k, v in convert.clip_text_state_dict(
        jax.tree.map(np.asarray, jclip.params)).items()})
    vae = VaeDecoder((8, 16), layers_per_block=1)
    vae.load_state_dict({k: torch.from_numpy(v) for k, v in convert.vae_decoder_state_dict(
        jax.tree.map(np.asarray, jvae.params)).items()})
    prompts = ["a cute cat", "a red car on a road"]
    noise = np.random.default_rng(11).standard_normal((2, 4, 72, 72)).astype(np.float32)
    kw = dict(n_iter=3, num_imgs=2, class_guidance=6, seeds=noise, img_size=72,
              output="uint8", sampler="ddim")
    jimg, jlat = jd.DiffusionGenerator(model=jmodel, params=params, vae=jvae).generate(
        labels=jclip.encode_text(prompts), **kw)
    img, lat = td.DiffusionGenerator(model.eval(), vae=vae.eval(), device="cpu").generate(
        labels=clip.eval().encode_text(prompts), **kw)
    assert img.shape == (2, 144, 144, 3) and img.dtype == torch.uint8
    assert lat.dtype == torch.float32
    assert rel_l2(lat.numpy(), np.asarray(jlat)) < 1e-4
    assert np.abs(img.numpy().astype(int) - np.asarray(jimg).astype(int)).max() <= 1

