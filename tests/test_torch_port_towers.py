"""The port's VAE decoder and CLIP text tower against the JAX package's,
on the same (random, JAX-initialised) weights at the tiny test sizes:
VaeConfig(block_out_channels=(8, 16), layers_per_block=1) and
ClipConfig(width=64, heads=2, layers=2)."""

import jax
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.models.clip import FlaxClip
from transformer_latent_diffusion_tpu.models.clip import tokenize as jax_tokenize
from transformer_latent_diffusion_tpu.models.vae import FlaxVae
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models.clip import ClipTextModel, tokenize
from transformer_latent_diffusion_tpu_torch.models.vae import VaeDecoder

torch.set_num_threads(2)

PROMPTS = ["a cute cat", "  A Photo of   an ASTRONAUT riding a horse ", "",
           "word " * 100]


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return module.eval()


@pytest.mark.parametrize("prompt", PROMPTS, ids=["short", "spaces", "empty", "long"])
def test_tokenize_matches_jax(prompt):
    """Byte-for-byte the same ids, truncation to 77 with EOT included."""
    np.testing.assert_array_equal(tokenize(prompt), jax_tokenize(prompt))
    np.testing.assert_array_equal(tokenize([prompt, "x"]),
                                  jax_tokenize([prompt, "x"]))


@pytest.mark.parametrize("blocks", [(8, 16), (8, 16, 32)], ids=["two", "three"])
def test_vae_decode_matches_jax(blocks):
    """float32 decode, NCHW in and out. 1e-5 relative to the image's scale
    (measured 1e-6) covers convolution and GroupNorm summation order
    (GroupNorm's variance is E[x^2]-E[x]^2 in flax, two-pass in torch)."""
    vae = FlaxVae.create(block_out_channels=blocks, layers_per_block=1,
                         sample_size=8)
    lat = np.random.default_rng(0).standard_normal((2, 4, 4, 4)).astype(np.float32)
    want = np.asarray(vae.decode(lat))
    port = _load(VaeDecoder(blocks, layers_per_block=1),
                 convert.vae_decoder_state_dict(jax.tree.map(np.asarray, vae.params)))
    got = port.decode(torch.from_numpy(lat)).numpy()
    assert got.shape == want.shape == (2, 3, 4 * 2 ** (len(blocks) - 1),
                                       4 * 2 ** (len(blocks) - 1))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5), ("float16", 5e-3)])
def test_clip_encode_text_matches_jax(dtype, bound):
    """Pooled text embeddings for the same prompts. float32: 1e-5 of the
    scale (summation order). float16: the towers round the block outputs to
    float16 at slightly different points, so 5e-3 of the scale (measured
    7e-4: a few float16 ulps after two blocks)."""
    jdt = {"float32": jax.numpy.float32, "float16": jax.numpy.float16}[dtype]
    tdt = {"float32": torch.float32, "float16": torch.float16}[dtype]
    clip = FlaxClip.create(width=64, heads=2, layers=2, embed_dim=64, dtype=jdt)
    want = np.asarray(clip.encode_text(PROMPTS), np.float32)
    port = _load(ClipTextModel(width=64, heads=2, layers=2, embed_dim=64, dtype=tdt),
                 convert.clip_text_state_dict(jax.tree.map(np.asarray, clip.params)))
    got = port.encode_text(PROMPTS)
    assert got.dtype == tdt and got.shape == (len(PROMPTS), 64)
    got = got.float().numpy()
    assert np.abs(got - want).max() < bound * np.abs(want).max()
