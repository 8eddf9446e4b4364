"""The VAE decoder (the SDXL "sdxl-vae-fp16-fix" AutoencoderKL graph), plain
PyTorch.

Counterpart of the decode half of the JAX package's `models/vae.py`.
Module names are diffusers' `AutoencoderKL` names, so a diffusers
state_dict (decoder and `post_quant_conv` keys) loads as it is. Layout is
NCHW throughout, so the convolutions run on cuDNN; GroupNorm uses
gcd(32, C) groups and eps 1e-6; Upsample is nearest-neighbour x2 then a
3x3 convolution. The encoder waits for the editing slice.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6


def _norm(channels: int, num_groups: int = 32) -> nn.GroupNorm:
    # sdxl-vae's channels are all multiples of 32; gcd keeps tiny test
    # configs valid
    return nn.GroupNorm(math.gcd(num_groups, channels), channels, eps=GN_EPS)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = _norm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = _norm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention (diffusers `Attention`), float32
    scores and softmax."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = _norm(channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        flat = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(flat), self.to_k(flat), self.to_v(flat)
        s = (q.float() @ k.float().transpose(1, 2)) * (1.0 / math.sqrt(c))
        attn = torch.softmax(s, dim=-1).to(v.dtype)
        out = self.to_out[0](attn @ v)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class MidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(channels, channels),
                                      ResnetBlock(channels, channels)])
        self.attentions = nn.ModuleList([AttnBlock(channels)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class UpBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_resnets: int,
                 upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels)
            for j in range(n_resnets))
        self.upsamplers = (nn.ModuleList([Upsample(out_channels)])
                           if upsample else None)

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Decoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int], layers_per_block: int,
                 latent_channels: int = 4, out_channels: int = 3):
        super().__init__()
        rev = list(reversed(block_out_channels))
        self.conv_in = nn.Conv2d(latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0])
        self.up_blocks = nn.ModuleList(
            UpBlock(rev[max(i - 1, 0)], ch, layers_per_block + 1,
                    upsample=i < len(rev) - 1)
            for i, ch in enumerate(rev))
        self.conv_norm_out = _norm(rev[-1])
        self.conv_out = nn.Conv2d(rev[-1], out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VaeDecoder(nn.Module):
    """`post_quant_conv` + `decoder` of an AutoencoderKL (the decode half)."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4):
        super().__init__()
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)
        self.decoder = Decoder(block_out_channels, layers_per_block,
                               latent_channels)

    @classmethod
    def from_config(cls, cfg) -> "VaeDecoder":
        return cls(cfg.block_out_channels, cfg.layers_per_block,
                   cfg.latent_channels)

    @torch.no_grad()
    def decode(self, lat_nchw: torch.Tensor) -> torch.Tensor:
        """latent (B, C, h, w) (already scaled) -> image (B, 3, 8h, 8w) ~[-1, 1],
        computed in the module's parameter dtype (`VaeConfig.vae_dtype`)."""
        dt = self.post_quant_conv.weight.dtype
        return self.decoder(self.post_quant_conv(lat_nchw.to(dt)))
