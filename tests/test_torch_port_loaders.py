"""Every weight format the JAX package loads, through the port's
`load_state_dict_file` and `DiffusionTransformer`: each file is written
here, on tiny towers, with the JAX package's own writers
(`torch_compat.write_safetensors`, `checkpoint.save_npz`) or torch's, and
must load the same tensors as the `.pth` route (torch.save of the port's
state_dict of the same weights): `.safetensors` (plain, an EMA
checkpoint's flat `model_ema.` keys, bf16), `.npz` parameter trees of the
denoiser, the VAE and the CLIP text tower, openai's TorchScript CLIP
archive, and HF transformers CLIP keys."""

import sys
from dataclasses import asdict

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.configs import DenoiserConfig as JaxDenoiserConfig
from transformer_latent_diffusion_tpu.models import Denoiser as JaxDenoiser
from transformer_latent_diffusion_tpu.models.clip import FlaxClip
from transformer_latent_diffusion_tpu.models.torch_compat import write_safetensors
from transformer_latent_diffusion_tpu.models.vae import FlaxVae
from transformer_latent_diffusion_tpu.train.checkpoint import save_npz
from transformer_latent_diffusion_tpu.utils import init_denoiser_params
from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models.clip import ClipTextModel
from transformer_latent_diffusion_tpu_torch.sampling.pipeline import DiffusionTransformer
from transformer_latent_diffusion_tpu_torch.utils.common import load_state_dict_file

torch.set_num_threads(2)

TINY = dict(image_size=8, embed_dim=64, n_layers=2, noise_embed_dims=64)
BLOCKS = (8, 16)


def _trees():
    """JAX parameter trees of the three towers, as numpy."""
    jcfg = JaxDenoiserConfig(**TINY)
    den = init_denoiser_params(JaxDenoiser(**asdict(jcfg)), jcfg, seed=1)
    vae = FlaxVae.create(block_out_channels=BLOCKS, layers_per_block=1, sample_size=8)
    clip = FlaxClip.create(width=64, heads=2, layers=2, embed_dim=64)
    return {k: jax.tree.map(np.asarray, v) for k, v in
            (("denoiser", den), ("vae", vae.params), ("clip", clip.params))}


@pytest.fixture(scope="module")
def trees():
    return _trees()


def _state_dict(kind, tree):
    if kind == "denoiser":
        return convert.denoiser_state_dict(tree, JaxDenoiserConfig(**TINY))
    return convert.vae_state_dict(tree) if kind == "vae" else convert.clip_text_state_dict(tree)


def _pth(tmp_path, sd, name="w.pth"):
    """The `.pth` route: torch.save of the state_dict, loaded back."""
    path = str(tmp_path / name)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    return load_state_dict_file(path)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)


@pytest.fixture
def no_safetensors_package(monkeypatch):
    """The port reads .safetensors with numpy, as the JAX package does:
    no `safetensors` package (which torch.load would otherwise hand the
    file to where it is installed)."""
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)


@pytest.mark.parametrize("ema", [False, True], ids=["plain", "model_ema"])
def test_safetensors_loads_as_pth(tmp_path, trees, ema, no_safetensors_package):
    """A .safetensors denoiser through the port's numpy reader; an EMA
    checkpoint's flat `model_ema.` keys are taken and stripped (the other
    entries dropped), as the JAX loader does."""
    sd = _state_dict("denoiser", trees["denoiser"])
    flat = {("model_ema." + k if ema else k): v for k, v in sd.items()}
    if ema:  # the raw model's weights beside the EMA ones
        flat.update({"model." + k: v + 1 for k, v in sd.items()})
    path = str(tmp_path / "w.safetensors")
    write_safetensors(flat, path)
    _assert_same(load_state_dict_file(path), _pth(tmp_path, sd))


def test_bf16_safetensors_loads_as_bf16(tmp_path, no_safetensors_package):
    """BF16 tensors (read as int16 bits, numpy having no bf16) load as
    torch.bfloat16 with the same values."""
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    path = str(tmp_path / "b.safetensors")
    write_safetensors({"w": vals, "b": np.arange(4, dtype=np.float32)}, path)
    got = load_state_dict_file(path)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(), vals.astype(np.float32))
    np.testing.assert_array_equal(got["b"].numpy(), np.arange(4, dtype=np.float32))


@pytest.mark.parametrize("kind", ["denoiser", "vae", "clip"])
def test_npz_tree_loads_as_pth(tmp_path, trees, kind):
    """A JAX parameter tree saved with the JAX package's save_npz (as
    scripts/convert_towers.py writes the towers): unflattened on "/" and
    converted to the port's state_dict."""
    path = str(tmp_path / f"{kind}.npz")
    save_npz(path, trees[kind])
    cfg = pc.DenoiserConfig(**TINY) if kind == "denoiser" else None
    _assert_same(load_state_dict_file(path, kind, cfg),
                 _pth(tmp_path, _state_dict(kind, trees[kind])))


def test_torchscript_clip_archive_loads_as_pth(tmp_path, trees):
    """openai publishes CLIP as a TorchScript archive, which torch.load
    refuses: the loader reads it with torch.jit.load."""
    sd = _state_dict("clip", trees["clip"])
    model = ClipTextModel(width=64, heads=2, layers=2, embed_dim=64)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    path = str(tmp_path / "ViT-tiny.pt")
    torch.jit.trace(model.eval(), torch.zeros(1, 77, dtype=torch.int64)).save(path)
    with pytest.raises(RuntimeError):  # what the .pth route alone did with it
        torch.load(path, map_location="cpu", weights_only=True)
    _assert_same(load_state_dict_file(path, "clip"), _pth(tmp_path, sd))


def _hf_layout(sd):
    """openai text-side keys -> HF transformers CLIPModel keys (q/k/v
    split, the projection transposed), with a vision key beside them."""
    pre = "text_model."
    out = {pre + "embeddings.token_embedding.weight": sd["token_embedding.weight"],
           pre + "embeddings.position_embedding.weight": sd["positional_embedding"],
           pre + "final_layer_norm.weight": sd["ln_final.weight"],
           pre + "final_layer_norm.bias": sd["ln_final.bias"],
           "text_projection.weight": np.ascontiguousarray(sd["text_projection"].T),
           "vision_model.post_layernorm.weight": np.ones(8, np.float32)}
    for i in range(2):
        src, dst = f"transformer.resblocks.{i}", f"{pre}encoder.layers.{i}"
        for part, w, b in zip("qkv", np.split(sd[f"{src}.attn.in_proj_weight"], 3),
                              np.split(sd[f"{src}.attn.in_proj_bias"], 3)):
            out[f"{dst}.self_attn.{part}_proj.weight"] = np.ascontiguousarray(w)
            out[f"{dst}.self_attn.{part}_proj.bias"] = np.ascontiguousarray(b)
        for a, b in (("attn.out_proj", "self_attn.out_proj"), ("ln_1", "layer_norm1"),
                     ("ln_2", "layer_norm2"), ("mlp.c_fc", "mlp.fc1"),
                     ("mlp.c_proj", "mlp.fc2")):
            out[f"{dst}.{b}.weight"] = sd[f"{src}.{a}.weight"]
            out[f"{dst}.{b}.bias"] = sd[f"{src}.{a}.bias"]
    return out


@pytest.mark.parametrize("fmt", ["safetensors", "pth"])
def test_hf_clip_keys_load_as_openai(tmp_path, trees, fmt, no_safetensors_package):
    """HF CLIP keys (model.safetensors, or a torch file) are renamed to
    openai's layout, as the JAX package's convert_hf_clip_state_dict
    does; vision keys are dropped."""
    sd = _state_dict("clip", trees["clip"])
    hf = _hf_layout(sd)
    path = str(tmp_path / f"model.{fmt}")
    if fmt == "safetensors":
        write_safetensors(hf, path)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in hf.items()}, path)
    got = {k: v.contiguous() for k, v in load_state_dict_file(path, "clip").items()}
    _assert_same(got, _pth(tmp_path, sd))


def test_transformer_builds_from_every_format(tmp_path, trees, no_safetensors_package):
    """DiffusionTransformer loads a .safetensors denoiser, an .npz VAE and
    a TorchScript CLIP archive strictly, with the same weights as the
    converted trees."""
    den_sd = _state_dict("denoiser", trees["denoiser"])
    write_safetensors(den_sd, str(tmp_path / "den.safetensors"))
    save_npz(str(tmp_path / "vae.npz"), trees["vae"])
    clip_sd = _state_dict("clip", trees["clip"])
    model = ClipTextModel(width=64, heads=2, layers=2, embed_dim=64)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in clip_sd.items()})
    torch.jit.trace(model.eval(), torch.zeros(1, 77, dtype=torch.int64)).save(
        str(tmp_path / "clip.pt"))
    cfg = pc.LTDConfig(
        denoiser_cfg=pc.DenoiserConfig(**TINY),
        denoiser_load=pc.DenoiserLoad(local_filename=str(tmp_path / "den.safetensors")),
        vae_cfg=pc.VaeConfig(block_out_channels=BLOCKS, layers_per_block=1,
                             weights_path=str(tmp_path / "vae.npz")),
        clip_cfg=pc.ClipConfig(width=64, heads=2, layers=2, embed_dim=64,
                               weights_path=str(tmp_path / "clip.pt")))
    tr = DiffusionTransformer(cfg, device="cpu")
    for module, sd in ((tr.diffuser.model, den_sd), (tr.vae, _state_dict("vae", trees["vae"])),
                       (tr.clip_model, clip_sd)):
        got = module.state_dict()
        for k, v in sd.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
