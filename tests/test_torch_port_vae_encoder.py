"""The port's VAE encoder against the JAX package's `FlaxVae` on the same
weights, at the tiny sizes of tests/test_torch_port_towers.py: the
posterior moments and `encode_mean`, `encode` with the JAX draw handed
over as eps, the weights bridge against the JAX package's converter in
the other direction, and the decoder-only keys still loading alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.models.torch_compat import (
    convert_torch_vae_state_dict,
)
from transformer_latent_diffusion_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from transformer_latent_diffusion_tpu.models.vae import FlaxVae
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models.vae import (
    AutoencoderKL,
    VaeDecoder,
)

torch.set_num_threads(2)

# float32 on both sides, the convolutions summed in other orders: the
# moments agree to ~2.5e-6 absolute (measured, values up to ~2), bounded
# here at 2e-5
ATOL = 2e-5


def jax_eps(shape_nchw):
    """The draw of `FlaxVae.encode`'s default key: PRNGKey(0), taken in
    NHWC (the module's layout), returned NCHW."""
    b, c, h, w = shape_nchw
    eps = jax.random.normal(jax.random.PRNGKey(0), (b, h, w, c), jnp.float32)
    return torch.from_numpy(np.array(eps).transpose(0, 3, 1, 2))


@pytest.fixture(scope="module", params=[(8, 16), (8, 16, 32)],
                ids=["two_blocks", "three_blocks"])
def vaes(request):
    blocks = request.param
    jvae = FlaxVae.create(block_out_channels=blocks, layers_per_block=1,
                          sample_size=16)
    params = jax.tree.map(np.asarray, jvae.params)
    port = AutoencoderKL(blocks, layers_per_block=1)
    port.load_state_dict({k: torch.from_numpy(v)
                          for k, v in convert.vae_state_dict(params).items()})
    img = np.random.default_rng(len(blocks)).uniform(
        -1, 1, (2, 3, 16, 16)).astype(np.float32)
    return blocks, jvae, params, port.eval(), img


def test_moments_and_encode_mean_match_jax(vaes):
    """(mean, logvar) of `encode_moments` and the `encode_mean` latent
    (B, 4, 16 / f, 16 / f) against JAX at ATOL; logvar clipped alike."""
    blocks, jvae, _, port, img = vaes
    jmean, jlogvar = jvae.module.apply(
        {"params": jvae.params}, jnp.asarray(img.transpose(0, 2, 3, 1)),
        method=JaxAutoencoderKL.encode_moments)
    mean, logvar = port.encode_moments(torch.from_numpy(img))
    f = 2 ** (len(blocks) - 1)
    assert mean.shape == logvar.shape == (2, 4, 16 // f, 16 // f)
    np.testing.assert_allclose(mean.numpy(),
                               np.asarray(jmean).transpose(0, 3, 1, 2), atol=ATOL)
    np.testing.assert_allclose(logvar.numpy(),
                               np.asarray(jlogvar).transpose(0, 3, 1, 2), atol=ATOL)
    np.testing.assert_allclose(port.encode_mean(torch.from_numpy(img)).numpy(),
                               np.asarray(jvae.encode_mean(img)), atol=ATOL)


def test_encode_with_the_jax_draw_matches_jax(vaes):
    """`encode(img, eps)` with JAX's PRNGKey(0) draw equals `FlaxVae.encode`
    at ATOL; without eps the port's own draw is fixed per call (seed 0),
    another than JAX's (ROADMAP §3)."""
    _, jvae, _, port, img = vaes
    want = np.asarray(jvae.encode(img))
    x = torch.from_numpy(img)
    got = port.encode(x, eps=jax_eps(want.shape))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    own = port.encode(x)
    torch.testing.assert_close(own, port.encode(x), atol=0, rtol=0)
    assert not torch.allclose(own, got)
    g = torch.Generator().manual_seed(3)
    assert not torch.equal(port.encode(x, generator=g), own)


def test_state_dict_inverts_the_jax_converter(vaes):
    """convert.vae_state_dict is the inverse of the JAX package's
    convert_torch_vae_state_dict: its keys are AutoencoderKL's own
    (diffusers' `encoder.*`, `quant_conv.*`, `decoder.*`,
    `post_quant_conv.*`), and the JAX converter maps them back onto the
    JAX tree exactly. The decoder's keys alone still load into
    VaeDecoder."""
    blocks, _, params, port, _ = vaes
    sd = convert.vae_state_dict(params)
    assert set(sd) == set(port.state_dict())
    back = convert_torch_vae_state_dict(sd, blocks, 1)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = jax.tree_util.tree_leaves_with_path(back)
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_array_equal(np.asarray(leaf), want[path])
    dec = VaeDecoder(blocks, layers_per_block=1)
    dec.load_state_dict({k: torch.from_numpy(v) for k, v in
                         convert.vae_decoder_state_dict(params).items()})
    enc = convert.vae_encoder_state_dict(params)
    assert all(k.startswith(("encoder.", "quant_conv.")) for k in enc)
    assert not set(enc) & set(dec.state_dict())
