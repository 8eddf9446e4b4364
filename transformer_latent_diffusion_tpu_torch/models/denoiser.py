"""The transformer denoiser, plain PyTorch.

Counterpart of the JAX package's `models/denoiser.py`: patchify ->
LayerNorm/Linear/LayerNorm embedding -> learned positional table -> N
decoder blocks -> out projection -> unpatchify, conditioned on a
2-token (noise level, text) sequence. Module names are the reference
torch `Denoiser`'s, so its state_dict loads as it is. Latents are NCHW.

The fused inference engine (`fast_denoiser.FusedEngine`) runs the same
parameters through the hand-written kernels; this module is the plain
version it is checked against, and what the pipeline runs on the CPU.
With `fused_layer_vjp=True` (training) its decoder blocks run as the
differentiable fused layer (TPU kernel K2), or, with the "mlp" or "moe"
FFN (`mlp_class`, `models.blocks.MLP_CLASSES`), their attention pair as
TPU kernel K6 (also asked for by `fused_attn_vjp`); the dense layers
before and after them stay plain PyTorch with autograd, as the JAX package
leaves them to XLA. Otherwise `use_pallas` and `fused_mlp_vjp` select the
hi-res kernels of the linen path (K3/K4 and K5, see
`models.blocks.DecoderBlock`). A MoE denoiser's Switch load-balancing
losses of its last forward add up in `moe_aux_loss()`. `remat=True` checkpoints each decoder
block (`torch.utils.checkpoint`, as the JAX package's
`nn.remat(DecoderBlock)`): its activations are recomputed in the backward
instead of stored, which 1024 px training needs.

A widened model (`input_channels` > `n_channels`, the outpainting
fine-tune) takes the noisy latent and `input_channels - n_channels`
context channels after it; only the patch projection's input widens, and
`expand_input_channels` widens a trained state_dict with zero rows.

Another grid than the native one takes the first h*w rows of the learned
positional table, or a table passed as `pos_embed_override`, such as
`resize_pos_embed`'s bilinear resize of it (what the sampler passes for a
non-native grid, and what `train.highres.upsample_denoiser_params` bakes
into a state_dict).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from transformer_latent_diffusion_tpu_torch.models.blocks import (
    LN_EPS,
    DecoderBlock,
    SinusoidalEmbedding,
    dense,
    gelu,
    layer_norm,
)


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, h*w, C*p*p) with (c, p1, p2) flatten order."""
    b, c, hh, ww = x.shape
    p = patch_size
    h, w = hh // p, ww // p
    x = x.reshape(b, c, h, p, w, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, h * w, c * p * p)


def unpatchify(x: torch.Tensor, patch_size: int, h: int, w: int,
               n_channels: int) -> torch.Tensor:
    """(B, h*w, C*p*p) -> (B, C, H, W); inverse of `patchify`."""
    b = x.shape[0]
    p = patch_size
    x = x.reshape(b, h, w, n_channels, p, p).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, n_channels, h * p, w * p)


def resize_pos_embed(pos_table: torch.Tensor, old_grid: int,
                     new_grid: int) -> torch.Tensor:
    """2D-resize a learned positional table for another token grid:
    (old_grid^2, D) -> (new_grid^2, D), bilinear with half-pixel centres
    and antialiasing when it shrinks, as the JAX package's
    `resize_pos_embed` (jax.image.resize, whose triangle-kernel weights
    `F.interpolate(antialias=True)` reproduces in both directions).
    Computed in float32, returned in the table's dtype."""
    d = pos_table.shape[-1]
    grid = pos_table.reshape(old_grid, old_grid, d).permute(2, 0, 1)[None]
    out = F.interpolate(grid.float(), size=(new_grid, new_grid),
                        mode="bilinear", align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).reshape(new_grid * new_grid, d) \
        .to(pos_table.dtype)


class _Patchify(nn.Module):
    """Stands at index 1 of `patchify_and_embed`, where the reference has
    its einops Rearrange, so the Sequential's indices match its keys."""

    def __init__(self, patch_size: int):
        super().__init__()
        self.patch_size = patch_size

    def forward(self, x):
        return patchify(x, self.patch_size)


def expand_input_channels(state_dict, old_channels: int, new_channels: int,
                          patch_size: int):
    """Zero-init widening of a `Denoiser` state_dict's patch projection
    from `old_channels` to `new_channels` input channels (the outpainting
    model, as the JAX package's `expand_input_channels`): the original
    channels come first, the appended ones have zero weights, so the
    widened model's output equals the original's for any context until
    fine-tuning moves them. Returns a new dict; the input is untouched."""
    if new_channels < old_channels:
        raise ValueError(f"cannot shrink input: {old_channels} -> "
                         f"{new_channels}")
    pp = patch_size * patch_size
    name = "denoiser_trans_block.patchify_and_embed.0.weight"
    w = state_dict[name]
    if w.shape[1] != old_channels:
        raise ValueError(f"patch_proj kernel has {w.shape[1] * pp} input rows, "
                         f"expected {old_channels}*{pp}")
    wide = w.new_zeros((w.shape[0], new_channels, *w.shape[2:]))
    wide[:, :old_channels] = w
    return {**state_dict, name: wide}


class DenoiserTransBlock(nn.Module):
    def __init__(self, patch_size: int, img_size: int, embed_dim: int,
                 n_layers: int, mlp_multiplier: int = 4, n_channels: int = 4,
                 dtype=torch.float32, fused_layer_vjp: bool = False,
                 use_pallas: bool = False, fused_mlp_vjp: bool = False,
                 remat: bool = False, fused_attn_vjp: bool = False,
                 mlp_class: str = "sep_conv", n_experts: int = 8,
                 expert_capacity_factor: float = 1.25,
                 input_channels: Optional[int] = None):
        super().__init__()
        self.patch_size = patch_size
        self.n_channels = n_channels
        self.dtype = dtype
        self.remat = remat
        patch_dim = n_channels * patch_size * patch_size
        seq_len = (img_size // patch_size) ** 2
        self.patchify_and_embed = nn.Sequential(
            nn.Conv2d(input_channels or n_channels, patch_dim,
                      kernel_size=patch_size, stride=patch_size),
            _Patchify(patch_size),
            nn.LayerNorm(patch_dim, eps=LN_EPS),
            nn.Linear(patch_dim, embed_dim),
            nn.LayerNorm(embed_dim, eps=LN_EPS),
        )
        self.pos_embed = nn.Embedding(seq_len, embed_dim)
        self.register_buffer("precomputed_pos_enc",
                             torch.arange(seq_len, dtype=torch.int64))
        self.decoder_blocks = nn.ModuleList(
            DecoderBlock(embed_dim, mlp_multiplier, dtype, fused_layer_vjp,
                         use_pallas, fused_mlp_vjp, fused_attn_vjp, mlp_class,
                         n_experts, expert_capacity_factor)
            for _ in range(n_layers))
        self.out_proj = nn.Sequential(nn.Linear(embed_dim, patch_dim))

    def forward(self, x, cond,
                pos_embed_override: Optional[torch.Tensor] = None):
        """pos_embed_override: an (h*w, D) table to add instead of the
        first h*w rows of the learned one."""
        dt = self.dtype
        p = self.patch_size
        b, c, hh, ww = x.shape
        h, w = hh // p, ww // p
        conv, _, norm1, embed, norm2 = self.patchify_and_embed
        tokens = patchify(x, p).to(dt)
        # the patchify convolution is a per-patch linear over (c, p1, p2)
        tokens = layer_norm(
            dense(tokens, conv.weight.reshape(conv.out_channels, -1),
                  conv.bias, dt), norm1, dt)
        tokens = layer_norm(dense(tokens, embed.weight, embed.bias, dt),
                            norm2, dt)
        pos = (self.pos_embed.weight[:h * w] if pos_embed_override is None
               else pos_embed_override)
        tokens = tokens + pos.to(dt)[None]
        remat = self.remat and torch.is_grad_enabled()
        for block in self.decoder_blocks:
            tokens = (checkpoint(block, tokens, cond, use_reentrant=False)
                      if remat else block(tokens, cond))
        out = dense(tokens, self.out_proj[0].weight, self.out_proj[0].bias, dt)
        return unpatchify(out.float(), p, h, w, self.n_channels)


class Denoiser(nn.Module):
    """forward(x, noise_level, label):
      x           (B, input_channels, S, S) noisy latent (and, on a widened
                  model, its context channels after it)
      noise_level (B, 1) in (0, 1)
      label       (B, text_emb_size) pooled CLIP text embedding
    returns the network's prediction (B, n_channels, S, S), float32."""

    def __init__(self, image_size: int, noise_embed_dims: int,
                 patch_size: int, embed_dim: int, dropout: float,
                 n_layers: int, text_emb_size: int = 768,
                 mlp_multiplier: int = 4, n_channels: int = 4,
                 mlp_class: str = "sep_conv", n_experts: int = 8,
                 expert_capacity_factor: float = 1.25,
                 input_channels=None, objective: str = "x0",
                 dtype=torch.float32, fused_layer_vjp: bool = False,
                 use_pallas: bool = False, fused_mlp_vjp: bool = False,
                 remat: bool = False, fused_attn_vjp: bool = False):
        super().__init__()
        if dropout:
            raise NotImplementedError("dropout > 0 belongs to the training "
                                      "slice (ROADMAP item 7)")
        self.image_size = image_size
        self.patch_size = patch_size
        self.n_channels = n_channels
        self.input_channels = input_channels
        self.objective = objective
        self.dtype = dtype
        self.mlp_class = mlp_class
        self.use_pallas = use_pallas
        self.fused_mlp_vjp = fused_mlp_vjp
        self.fourier_feats = nn.Sequential(
            SinusoidalEmbedding(noise_embed_dims),
            nn.Linear(noise_embed_dims, embed_dim),
            nn.GELU(),
            nn.Linear(embed_dim, embed_dim),
        )
        self.label_proj = nn.Linear(text_emb_size, embed_dim)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.denoiser_trans_block = DenoiserTransBlock(
            patch_size, image_size, embed_dim, n_layers, mlp_multiplier,
            n_channels, dtype, fused_layer_vjp, use_pallas, fused_mlp_vjp,
            remat, fused_attn_vjp, mlp_class, n_experts,
            expert_capacity_factor, input_channels)

    @classmethod
    def from_config(cls, cfg, dtype=torch.float32,
                    fused_layer_vjp: bool = False, use_pallas: bool = False,
                    fused_mlp_vjp: bool = False, remat: bool = False,
                    fused_attn_vjp: bool = False) -> "Denoiser":
        from dataclasses import asdict

        return cls(**asdict(cfg), dtype=dtype, fused_layer_vjp=fused_layer_vjp,
                   use_pallas=use_pallas, fused_mlp_vjp=fused_mlp_vjp,
                   remat=remat, fused_attn_vjp=fused_attn_vjp)

    def moe_aux_loss(self) -> torch.Tensor:
        """The sum over the decoder blocks of the Switch load-balancing
        loss of the last forward (the JAX package's sown "losses"
        collection); a "moe" denoiser only."""
        blocks = self.denoiser_trans_block.decoder_blocks
        return sum(b.mlp.aux_loss for b in blocks)

    def forward(self, x, noise_level, label,
                pos_embed_override: Optional[torch.Tensor] = None):
        dt = self.dtype
        sin, lin1, _, lin2 = self.fourier_feats
        nemb = sin(noise_level.to(dt))
        nemb = dense(gelu(dense(nemb, lin1.weight, lin1.bias, dt)),
                     lin2.weight, lin2.bias, dt)
        lemb = dense(label, self.label_proj.weight, self.label_proj.bias, dt)
        cond = layer_norm(torch.stack([nemb, lemb], dim=1), self.norm, dt)
        return self.denoiser_trans_block(x, cond, pos_embed_override)
