"""High-resolution scaling: positional-table upsampling of a denoiser.

Counterpart of the JAX package's `train/highres.py`. A 512 or 1024 px
deployment is the 256 px model with its learned positional table
bilinear-resized onto the larger token grid (16 x 16 -> 32 x 32 -> 64 x 64
at patch size 2); every other parameter is per-patch or per-token and
carries over as it is:

    sd_512 = upsample_denoiser_params(denoiser.state_dict(), 32, 64, 2)
    Denoiser.from_config(DenoiserConfig(image_size=64, ...)).load_state_dict(sd_512)

`finetune_highres` is that upsample followed by `train.main` at the new
size, warm-started from the result (the reference's 512 and 1024 px
fine-tunes from the 256 px checkpoint).
"""

from __future__ import annotations

from typing import Dict

import torch

from transformer_latent_diffusion_tpu_torch.models.denoiser import (
    resize_pos_embed,
)

POS_EMBED = "denoiser_trans_block.pos_embed.weight"
POS_INDEX = "denoiser_trans_block.precomputed_pos_enc"


def upsample_denoiser_params(state_dict: Dict[str, torch.Tensor],
                             old_image_size: int, new_image_size: int,
                             patch_size: int) -> Dict[str, torch.Tensor]:
    """A new `Denoiser` state_dict with the positional table resized from
    the old image size's token grid to the new one's (and the positional
    index buffer lengthened to match); the other entries are shared."""
    old_grid = old_image_size // patch_size
    new_grid = new_image_size // patch_size
    out = dict(state_dict)
    out[POS_EMBED] = resize_pos_embed(state_dict[POS_EMBED], old_grid, new_grid)
    out[POS_INDEX] = torch.arange(new_grid * new_grid, dtype=torch.int64,
                                  device=state_dict[POS_INDEX].device)
    return out


def finetune_highres(config, base_state_dict: Dict[str, torch.Tensor],
                     old_image_size: int, device):
    """Upsample the positional table of a trained base model's state_dict
    (`old_image_size`) to `config.denoiser_config.image_size` and run
    `train.main` on `device` ("cuda" or "cpu", required) from it; returns
    `train.main`'s result. As in the JAX package, schedule_shift="auto"
    resolves to no shift here (the new size is the model's native one):
    pass new / old size explicitly to train with the shift."""
    from transformer_latent_diffusion_tpu_torch.train.train import main

    den = config.denoiser_config
    state_dict = upsample_denoiser_params(base_state_dict, old_image_size,
                                          den.image_size, den.patch_size)
    return main(config, device, init_state_dict=state_dict)
