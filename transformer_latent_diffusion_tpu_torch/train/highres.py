"""High-resolution scaling: positional-table upsampling of a denoiser.

Counterpart of the JAX package's `train/highres.py`. A 512 or 1024 px
deployment is the 256 px model with its learned positional table
bilinear-resized onto the larger token grid (16 x 16 -> 32 x 32 -> 64 x 64
at patch size 2); every other parameter is per-patch or per-token and
carries over as it is:

    sd_512 = upsample_denoiser_params(denoiser.state_dict(), 32, 64, 2)
    Denoiser.from_config(DenoiserConfig(image_size=64, ...)).load_state_dict(sd_512)

The fine-tune that follows it in the JAX package (`finetune_highres`)
belongs to the hi-res training slice.
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


def finetune_highres(config, base_params, old_image_size: int):
    raise NotImplementedError(
        "finetune_highres is not ported yet: hi-res training (the attention "
        "backward K4, K5's backward, remat, multires) is the hi-res "
        "training slice (ROADMAP 1d)")
