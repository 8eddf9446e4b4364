"""Transformer building blocks of the denoiser, plain PyTorch.

Counterpart of the JAX package's `models/blocks.py`. Module and
parameter names follow the reference torch `Denoiser`'s state_dict, so
its checkpoints load as they are. Tokens are (B, N, D); the depthwise
convolution runs on an NHWC view of the token grid, with its taps in the
order of the flax HWIO kernel (3, 3, 1, hidden).

Each module holds float32 parameters and computes in its `dtype`, as
flax modules do: dense inputs and weights are cast to `dtype`, LayerNorm
statistics and softmax stay float32. Dropout only at 0. The FFN is one of
`MLP_CLASSES`: the LocalViT sep-conv MLP (the default), the plain `MLP`,
or the Switch mixture of experts (`models.moe.MoEMLP`).
`DecoderBlock(fused_layer_vjp=True)` runs the whole sep-conv layer as
`ops.fused_layer_vjp.FusedLayerFunction` (TPU kernel K2) where the JAX
package's gate allows it; a block of at most 256 tokens outside that gate
runs its attention pair as `ops.fused_attn_vjp` (TPU kernel K6). Otherwise
(the linen path), `use_pallas` sends self-attention to the flash-attention
kernels (K3 forward, K4 backward, `ops.attention`) and `fused_mlp_vjp`
sends the sep-conv MLP of a square grid of at most `FUSED_MLP_MAX_TOKENS`
tokens to K5 (`ops.fused_mlp_vjp`, forward and backward), as the JAX
package's flags do; a fused-layer block beyond K2's gate takes K5 too (the
JAX block's `want_mlp`); cross-attention stays plain.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from transformer_latent_diffusion_tpu_torch.models.moe import MoEMLP
from transformer_latent_diffusion_tpu_torch.ops.attention import (
    multi_head_attention,
)
from transformer_latent_diffusion_tpu_torch.ops.fused_attn_vjp import (
    fused_attention_pair_vjp,
)
from transformer_latent_diffusion_tpu_torch.ops.fused_mlp_vjp import (
    fused_mlp_sepconv,
)

LN_EPS = 1e-5
# the fused decoder layer's token limit (the JAX package's
# FUSED_LAYER_MAX_TOKENS)
FUSED_LAYER_MAX_TOKENS = 256
# the fused attention pair's token limit (the JAX package's
# FUSED_ATTN_MAX_TOKENS)
FUSED_ATTN_MAX_TOKENS = 256
# the fused sep-conv MLP's token limit (the JAX package's
# FUSED_MLP_MAX_TOKENS)
FUSED_MLP_MAX_TOKENS = 1024


def sinusoidal_embedding(x: torch.Tensor, embedding_dims: int = 32,
                         emb_min_freq: float = 1.0,
                         emb_max_freq: float = 1000.0) -> torch.Tensor:
    """Log-spaced sin/cos features of a noise level: (..., 1) -> (..., dims).

    The frequency table is built in float64 on the host and cast once to
    `x.dtype`, as the JAX package does."""
    speeds = _angular_speeds(embedding_dims, emb_min_freq, emb_max_freq,
                             x.device, x.dtype)
    return torch.cat([torch.sin(speeds * x), torch.cos(speeds * x)], dim=-1)


@functools.lru_cache(maxsize=None)
def _angular_speeds(embedding_dims: int, emb_min_freq: float,
                    emb_max_freq: float, device: torch.device, dtype):
    """The frequency table on `device`, copied there once: a sampler loop
    captured into a CUDA graph copies nothing from the host."""
    freqs = np.exp(np.linspace(math.log(emb_min_freq), math.log(emb_max_freq),
                               embedding_dims // 2))
    return torch.as_tensor(2.0 * np.pi * freqs, device=device).to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def dense(x: torch.Tensor, weight: torch.Tensor, bias, dtype) -> torch.Tensor:
    """x @ weight.T + bias with operands cast to `dtype`; weight is (out, in)."""
    return F.linear(x.to(dtype), weight.to(dtype),
                    None if bias is None else bias.to(dtype))


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype) -> torch.Tensor:
    """LayerNorm with float32 statistics, result cast to `dtype`."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                     norm.bias.float(), norm.eps)
    return y.to(dtype)


class SinusoidalEmbedding(nn.Module):
    """Holds the reference's `angular_speeds` buffer so that its state_dict
    loads; the forward recomputes the table in float64 like the JAX
    package (`sinusoidal_embedding`)."""

    def __init__(self, embedding_dims: int):
        super().__init__()
        self.embedding_dims = embedding_dims
        half = embedding_dims // 2
        freqs = np.exp(np.linspace(math.log(1.0), math.log(1000.0), half))
        self.register_buffer("angular_speeds", torch.as_tensor(
            2.0 * np.pi * freqs, dtype=torch.float32))

    def forward(self, x):
        return sinusoidal_embedding(x, self.embedding_dims)


class SelfAttention(nn.Module):
    """Fused-QKV self-attention; use_pallas: the K3 kernel route."""

    def __init__(self, embed_dim: int, n_heads: int, dtype=torch.float32,
                 use_pallas: bool = False):
        super().__init__()
        self.n_heads = n_heads
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.qkv_linear = nn.Linear(embed_dim, 3 * embed_dim, bias=False)

    def forward(self, x):
        qkv = dense(x, self.qkv_linear.weight, None, self.dtype)
        q, k, v = qkv.chunk(3, dim=-1)
        return multi_head_attention(q, k, v, self.n_heads, self.use_pallas)


class CrossAttention(nn.Module):
    """Q from the tokens, K and V from the 2-token conditioning sequence."""

    def __init__(self, embed_dim: int, n_heads: int, dtype=torch.float32):
        super().__init__()
        self.n_heads = n_heads
        self.dtype = dtype
        self.q_linear = nn.Linear(embed_dim, embed_dim, bias=False)
        self.kv_linear = nn.Linear(embed_dim, 2 * embed_dim, bias=False)

    def forward(self, x, y):
        q = dense(x, self.q_linear.weight, None, self.dtype)
        kv = dense(y, self.kv_linear.weight, None, self.dtype)
        k, v = kv.chunk(2, dim=-1)
        return multi_head_attention(q, k, v, self.n_heads)


class MLP(nn.Module):
    """Linear -> exact GELU -> Linear (the reference `MLP`); `mlp` keeps the
    reference's Sequential indices (Linear, GELU, Linear, Dropout)."""

    def __init__(self, embed_dim: int, mlp_multiplier: int,
                 dtype=torch.float32):
        super().__init__()
        hidden = mlp_multiplier * embed_dim
        self.dtype = dtype
        self.mlp = nn.Sequential(nn.Linear(embed_dim, hidden), nn.GELU(),
                                 nn.Linear(hidden, embed_dim), nn.Dropout(0.0))

    def forward(self, x):
        expand, _, contract, _ = self.mlp
        h = gelu(dense(x, expand.weight, expand.bias, self.dtype))
        return dense(h, contract.weight, contract.bias, self.dtype)


def depthwise_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """3x3 depthwise convolution with zero padding on an NHWC grid, as nine
    shifted multiply-adds in x's dtype (the JAX package's order).

    weight: the reference layout (C, 1, 3, 3); bias: (C,)."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = weight[:, 0].to(x.dtype)  # (C, 3, 3)
    acc = torch.zeros_like(x)
    for di in range(3):
        for dj in range(3):
            acc = acc + xp[:, di:di + h, dj:dj + w, :] * taps[:, di, dj]
    return acc + bias.to(x.dtype)


class MLPSepConv(nn.Module):
    """LocalViT FFN: 1x1 conv -> 3x3 depthwise -> GELU -> 1x1 conv, on the
    square token grid. `mlp` keeps the reference's Sequential indices.

    fused_vjp: on a square grid of at most FUSED_MLP_MAX_TOKENS tokens, run
    K5 (`ops.fused_mlp_vjp.fused_mlp_sepconv`, differentiable: float32
    hidden state, the GELU output rounded to `dtype`); elsewhere, and
    without the flag, the plain modules in `dtype` throughout."""

    def __init__(self, embed_dim: int, mlp_multiplier: int,
                 dtype=torch.float32, fused_vjp: bool = False):
        super().__init__()
        hidden = mlp_multiplier * embed_dim
        self.dtype = dtype
        self.fused_vjp = fused_vjp
        self.mlp = nn.Sequential(
            nn.Conv2d(embed_dim, hidden, kernel_size=1),
            nn.Conv2d(hidden, hidden, kernel_size=3, padding=1, groups=hidden),
            nn.GELU(),
            nn.Conv2d(hidden, embed_dim, kernel_size=1),
            nn.Dropout(0.0),
        )

    def forward(self, x):
        b, n, d = x.shape
        hw = math.isqrt(n)
        expand, dw, _, contract, _ = self.mlp
        if self.fused_vjp and hw * hw == n and n <= FUSED_MLP_MAX_TOKENS:
            dt = self.dtype
            out = fused_mlp_sepconv(
                x.to(dt), expand.weight[:, :, 0, 0].to(dt), expand.bias.float(),
                dw.weight.reshape(dw.out_channels, 9).T.contiguous().to(dt),
                dw.bias.float(), contract.weight[:, :, 0, 0].to(dt),
                contract.bias.float(), hw)
            return out.to(dt)
        h = dense(x.reshape(b, hw, hw, d), expand.weight[:, :, 0, 0],
                  expand.bias, self.dtype)
        h = gelu(depthwise_conv3x3(h, dw.weight, dw.bias))
        out = dense(h, contract.weight[:, :, 0, 0], contract.bias, self.dtype)
        return out.reshape(b, n, d)


# DenoiserConfig.mlp_class -> the FFN module (the JAX package's MLP_CLASSES)
MLP_CLASSES = {"sep_conv": MLPSepConv, "mlp": MLP, "moe": MoEMLP}


class DecoderBlock(nn.Module):
    """Pre-LN DiT block: x += SA(LN x); x += CA(LN x, cond); x += MLP(LN x).
    Heads = embed_dim // 64; the FFN is `MLP_CLASSES[mlp_class]` (the MoE
    one with n_experts and capacity_factor). The JAX block's gates
    (models/blocks.py:269-284), per call on the token count:

    - use_layer: fused_layer_vjp with the sep-conv FFN on a square grid of
      at most 256 tokens runs the layer as one `FusedLayerFunction` (K2);
    - use_attn: fused_attn_vjp, or a fused-layer block outside K2's gate
      (the FFN is "mlp" or "moe", or the grid is not square), of at most
      256 tokens runs the attention pair as `fused_attention_pair_vjp`
      (K6), then the FFN;
    - use_mlp: fused_mlp_vjp, or a fused-layer block beyond K2's gate, on
      a square grid of at most 1024 tokens runs the sep-conv MLP through
      K5 (the MLP module's own gate: a fused-layer block builds it with
      fused_vjp, which inside K2's gate it never calls).

    Otherwise the linen path (models/blocks.py:356-378): use_pallas sends
    self-attention to K3/K4, with the residual adds in `dtype`."""

    def __init__(self, embed_dim: int, mlp_multiplier: int,
                 dtype=torch.float32, fused_layer_vjp: bool = False,
                 use_pallas: bool = False, fused_mlp_vjp: bool = False,
                 fused_attn_vjp: bool = False, mlp_class: str = "sep_conv",
                 n_experts: int = 8, capacity_factor: float = 1.25):
        super().__init__()
        if mlp_class not in MLP_CLASSES:
            raise ValueError(f"unknown mlp_class {mlp_class!r}; expected one "
                             f"of {sorted(MLP_CLASSES)}")
        n_heads = embed_dim // 64
        self.dtype = dtype
        self.fused_layer_vjp = fused_layer_vjp
        self.fused_attn_vjp = fused_attn_vjp
        self.mlp_class = mlp_class
        self.norm1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.self_attention = SelfAttention(embed_dim, n_heads, dtype,
                                            use_pallas)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.cross_attention = CrossAttention(embed_dim, n_heads, dtype)
        self.norm3 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        if mlp_class == "sep_conv":
            self.mlp = MLPSepConv(embed_dim, mlp_multiplier, dtype,
                                  fused_mlp_vjp or fused_layer_vjp)
        elif mlp_class == "mlp":
            self.mlp = MLP(embed_dim, mlp_multiplier, dtype)
        else:
            self.mlp = MoEMLP(embed_dim, mlp_multiplier, dtype, n_experts,
                              capacity_factor)

    def _fused(self, x, y, hw: int):
        from transformer_latent_diffusion_tpu_torch.ops.fused_layer_vjp import (
            fused_layer,
        )

        dt = self.dtype
        expand, dw, _, contract, _ = self.mlp.mlp
        # weights cast to the compute dtype, LayerNorm and biases float32,
        # as the JAX package feeds its kernel (models/blocks.py:309-326)
        params = [
            self.norm1.weight.float(), self.norm1.bias.float(),
            self.self_attention.qkv_linear.weight.to(dt),
            self.norm2.weight.float(), self.norm2.bias.float(),
            self.cross_attention.q_linear.weight.to(dt),
            self.cross_attention.kv_linear.weight.to(dt),
            self.norm3.weight.float(), self.norm3.bias.float(),
            expand.weight[:, :, 0, 0].to(dt), expand.bias.float(),
            dw.weight.reshape(dw.out_channels, 9).T.to(dt), dw.bias.float(),
            contract.weight[:, :, 0, 0].to(dt), contract.bias.float(),
        ]
        out = fused_layer(x.to(dt), y.to(dt), params,
                          self.self_attention.n_heads, hw)
        return out.to(dt)

    def _fused_attn(self, x, y):
        dt = self.dtype
        # weights cast to the compute dtype, LayerNorm float32, as the JAX
        # package feeds its kernel (models/blocks.py:341-355)
        out = fused_attention_pair_vjp(
            x.to(dt), y.to(dt),
            self.norm1.weight.float(), self.norm1.bias.float(),
            self.self_attention.qkv_linear.weight.to(dt),
            self.norm2.weight.float(), self.norm2.bias.float(),
            self.cross_attention.q_linear.weight.to(dt),
            self.cross_attention.kv_linear.weight.to(dt),
            self.self_attention.n_heads)
        return out.to(dt)

    def forward(self, x, y):
        n = x.shape[1]
        hw = math.isqrt(n)
        use_layer = (self.fused_layer_vjp and self.mlp_class == "sep_conv"
                     and hw * hw == n and n <= FUSED_LAYER_MAX_TOKENS)
        if use_layer:
            return self._fused(x, y, hw)
        want_attn = self.fused_attn_vjp or self.fused_layer_vjp
        dt = self.dtype
        if want_attn and n <= FUSED_ATTN_MAX_TOKENS:
            x = self._fused_attn(x, y)
        else:
            x = x + self.self_attention(layer_norm(x, self.norm1, dt))
            x = x + self.cross_attention(layer_norm(x, self.norm2, dt), y)
        return x + self.mlp(layer_norm(x, self.norm3, dt))
