"""The VAE (the SDXL "sdxl-vae-fp16-fix" AutoencoderKL graph), plain
PyTorch.

Counterpart of the JAX package's `models/vae.py`: `VaeDecoder` is the
decode half (`post_quant_conv` + `decoder`), what text-to-image sampling
and the training eval need; `AutoencoderKL` adds the encode half
(`encoder` + `quant_conv`) that image editing needs. Module names are
diffusers' `AutoencoderKL` names, so a diffusers state_dict loads as it
is (the decoder's keys alone into `VaeDecoder`). Layout is NCHW
throughout, so the convolutions run on cuDNN; GroupNorm uses gcd(32, C)
groups and eps 1e-6; Upsample is nearest-neighbour x2 then a 3x3
convolution; Downsample pads H and W by (0, 1) and runs a stride-2 VALID
3x3 convolution, as diffusers does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        # diffusers pads one row and column at the end, then a VALID conv
        return self.conv(F.pad(x, (0, 1, 0, 1)))


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


class DownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_resnets: int,
                 downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels)
            for j in range(n_resnets))
        self.downsamplers = (nn.ModuleList([Downsample(out_channels)])
                             if downsample else None)

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class Encoder(nn.Module):
    """image (B, 3, H, W) -> moments (B, 2 * latent_channels, H/f, W/f),
    f = 2^(len(block_out_channels) - 1)."""

    def __init__(self, block_out_channels: Sequence[int], layers_per_block: int,
                 latent_channels: int = 4, in_channels: int = 3):
        super().__init__()
        ch = list(block_out_channels)
        self.conv_in = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            DownBlock(ch[max(i - 1, 0)], c, layers_per_block,
                      downsample=i < len(ch) - 1)
            for i, c in enumerate(ch))
        self.mid_block = MidBlock(ch[-1])
        self.conv_norm_out = _norm(ch[-1])
        self.conv_out = nn.Conv2d(ch[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, img):
        x = self.conv_in(img)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


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


class AutoencoderKL(VaeDecoder):
    """Both halves of the KL autoencoder: `VaeDecoder`'s, then `encoder` +
    `quant_conv` (registered after the decoder, so seeded random weights
    give the decoder the values `VaeDecoder` gets)."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4):
        super().__init__(block_out_channels, layers_per_block, latent_channels)
        self.encoder = Encoder(block_out_channels, layers_per_block,
                               latent_channels)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)

    @torch.no_grad()
    def encode_moments(self, img_nchw: torch.Tensor):
        """image (B, 3, H, W) in [-1, 1] -> (mean, logvar) of the latent
        posterior, logvar clipped to [-30, 20], in the parameter dtype."""
        dt = self.quant_conv.weight.dtype
        moments = self.quant_conv(self.encoder(img_nchw.to(dt)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    @torch.no_grad()
    def encode_mean(self, img_nchw: torch.Tensor) -> torch.Tensor:
        """The posterior mean (B, C, H/f, W/f), float32, unscaled."""
        return self.encode_moments(img_nchw)[0].float()

    @torch.no_grad()
    def encode(self, img_nchw: torch.Tensor, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A latent sample mean + exp(logvar / 2) eps (B, C, H/f, W/f),
        float32, unscaled. eps: the standard normal draw, else drawn from
        `generator` or a CPU `torch.Generator` seeded with 0 (a fixed draw
        per call, as the JAX package's `FlaxVae.encode` takes PRNGKey(0);
        the two draws differ, so pass JAX's as eps to replay it)."""
        mean, logvar = self.encode_moments(img_nchw)
        if eps is None:
            gen = generator or torch.Generator(device="cpu").manual_seed(0)
            eps = torch.randn(mean.shape, generator=gen, dtype=torch.float32)
        eps = eps.to(device=mean.device, dtype=mean.dtype)
        return (mean + torch.exp(logvar / 2) * eps).float()
