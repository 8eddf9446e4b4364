"""The fused inference engine of the denoiser.

Counterpart of the JAX package's `models/fast_denoiser.py`: a pure-function
engine over the same parameters as `models.denoiser.Denoiser` (here its
state_dict, in the reference layout). The prologue (noise and label
embeddings, patchify, embedding projections, positional table) and the
epilogue (out projection, unpatchify) are plain PyTorch, as the JAX
engine leaves them to XLA; the decoder layers run through
`ops.fused_stack.fused_layer_stack`, which on CUDA tensors is the four
hand-written kernels and on CPU tensors their plain versions, or, with
`quantize="int8"`, through the W8A8 stack
`ops.fused_stack_int8.fused_layer_stack_int8` (TPU kernel K7).

`prepare(params)` packs the per-layer weights once, outside the sampling
loop (the sampler keeps them while the model's weights do not change);
`apply_prepared(...)` runs one forward and `apply_prepared_cached(...)`
one block-cached forward. A widened (outpainting) model takes its context
channels after the latent's: the prologue's patch product reads the
(patch_dim, input_channels, p, p) weight flattened channel-major, the
order `patchify` gives the tokens, so only its K grows. Numerics:
float32 LayerNorm statistics, softmax and accumulation inside the layer
kernels; activations cross layers in `compute_dtype`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from transformer_latent_diffusion_tpu_torch.models.blocks import (
    LN_EPS,
    gelu,
    sinusoidal_embedding,
)
from transformer_latent_diffusion_tpu_torch.models.denoiser import (
    patchify,
    unpatchify,
)
from transformer_latent_diffusion_tpu_torch.ops.fused_stack import (
    fused_layer_stack,
    pack_layer_stack,
)
from transformer_latent_diffusion_tpu_torch.ops.fused_stack_int8 import (
    fused_layer_stack_int8,
    pack_layer_stack_int8,
)

QUANTIZE_MODES = (None, "int8")


def _ln(x, params, name):
    """LayerNorm with float32 statistics, result in x's dtype."""
    x32 = x.float()
    m = x32.mean(-1, keepdim=True)
    var = (x32 - m).square().mean(-1, keepdim=True)
    out = (x32 - m) * torch.rsqrt(var + LN_EPS)
    return (out * params[f"{name}.weight"] + params[f"{name}.bias"]).to(x.dtype)


def _dense(x, params, name, dtype):
    out = x.to(dtype) @ params[f"{name}.weight"].to(dtype).T
    bias = params.get(f"{name}.bias")
    return out if bias is None else out + bias.to(dtype)


class FusedEngine:
    """Callable engine with a hoistable weight-packing stage.

    quantize: None (weights and activations in `compute_dtype`) or
    "int8", the JAX package's opt-in W8A8 engine: the QKV, cross-attention
    Q, expand and contract products in int8 with per-row activation and
    per-output-channel weight scales (`ops/fused_stack_int8.py`)."""

    def __init__(self, cfg, compute_dtype=torch.bfloat16,
                 quantize: str | None = None):
        if quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode: {quantize!r}")
        self.cfg = cfg
        self.dtype = compute_dtype
        self.quantize = quantize
        self.n_heads = cfg.embed_dim // 64
        int8 = quantize == "int8"
        self._pack = pack_layer_stack_int8 if int8 else pack_layer_stack
        self._stack = fused_layer_stack_int8 if int8 else fused_layer_stack

    def prepare(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        """Pack each layer's weights (once, outside the sampling loop).
        params: a `Denoiser` state_dict. One `fused_layer_stack` call per
        layer, as the JAX engine runs its kernel: the residual is float32
        within a call and rounded to `compute_dtype` at its end, so this
        keeps the JAX engine's rounding between layers. With
        quantize="int8" the four large projections are quantized here."""
        layers = [self._pack(params, [i], self.dtype)
                  for i in range(self.cfg.n_layers)]
        return {"params": params, "layers": layers}

    def _prologue(self, params, x, noise_level, label):
        cfg = self.cfg
        dt = self.dtype
        nemb = sinusoidal_embedding(noise_level.to(dt), cfg.noise_embed_dims)
        nemb = _dense(nemb, params, "fourier_feats.1", dt)
        nemb = _dense(gelu(nemb), params, "fourier_feats.3", dt)
        lemb = _dense(label.to(dt), params, "label_proj", dt)
        cond = _ln(torch.stack([nemb, lemb], dim=1), params, "norm")

        pre = "denoiser_trans_block"
        b, c, hh, ww = x.shape
        p_sz = cfg.patch_size
        h, w = hh // p_sz, ww // p_sz
        conv_w = params[f"{pre}.patchify_and_embed.0.weight"]
        tokens = patchify(x, p_sz).to(dt)
        tokens = tokens @ conv_w.reshape(conv_w.shape[0], -1).to(dt).T \
            + params[f"{pre}.patchify_and_embed.0.bias"].to(dt)
        tokens = _ln(tokens, params, f"{pre}.patchify_and_embed.2")
        tokens = _ln(_dense(tokens, params, f"{pre}.patchify_and_embed.3", dt),
                     params, f"{pre}.patchify_and_embed.4")
        pos = params[f"{pre}.pos_embed.weight"][:h * w]
        tokens = tokens + pos.to(dt)[None]
        return tokens.contiguous(), cond.contiguous(), h, w

    def _epilogue(self, params, tokens, h, w):
        cfg = self.cfg
        out = _dense(tokens, params, "denoiser_trans_block.out_proj.0",
                     self.dtype)
        return unpatchify(out.float(), cfg.patch_size, h, w, cfg.n_channels)

    def _run_layers(self, prepared, tokens, cond, hw, lo, hi):
        for layer in prepared["layers"][lo:hi]:
            tokens = self._stack(tokens, cond, layer, hw=hw,
                                 n_heads=self.n_heads)
        return tokens

    def apply_prepared(self, prepared, x, noise_level, label):
        params = prepared["params"]
        tokens, cond, h, w = self._prologue(params, x, noise_level, label)
        tokens = self._run_layers(prepared, tokens, cond, h, 0,
                                  self.cfg.n_layers)
        return self._epilogue(params, tokens, h, w)

    def cache_span(self) -> tuple:
        """The cached layers [s, e) of block caching: the middle half of the
        decoder (one layer per call, so layers 3-8 of the flagship's 12),
        as the JAX engine's `cache_span` over its one-layer groups."""
        n = self.cfg.n_layers
        s, e = n // 4, n - n // 4
        return (s, max(e, s + 1))

    def apply_prepared_cached(self, prepared, x, noise_level, label, delta,
                              refresh: bool):
        """Block-cached forward (Delta-DiT): the span's residual
        contribution `delta` (B, N, D) in `compute_dtype` is recomputed when
        `refresh` is true and reused otherwise. Returns (output, delta).
        `refresh` is a Python bool: the sampler's schedule is static, so
        the host picks the branch (a captured loop holds the branch of
        each step); `delta` is not read when it is true."""
        params = prepared["params"]
        tokens, cond, h, w = self._prologue(params, x, noise_level, label)
        s, e = self.cache_span()
        tokens = self._run_layers(prepared, tokens, cond, h, 0, s)
        if refresh:
            out = self._run_layers(prepared, tokens, cond, h, s, e)
            tokens, delta = out, out - tokens
        else:
            tokens = tokens + delta.to(tokens.dtype)
        tokens = self._run_layers(prepared, tokens, cond, h, e,
                                  self.cfg.n_layers)
        return self._epilogue(params, tokens, h, w), delta

    def __call__(self, params, x, noise_level, label):
        return self.apply_prepared(self.prepare(params), x, noise_level, label)


def make_fused_apply(cfg, compute_dtype=torch.bfloat16,
                     quantize: str | None = None) -> FusedEngine:
    """Build the fused engine; mirrors `Denoiser.forward`."""
    return FusedEngine(cfg, compute_dtype=compute_dtype, quantize=quantize)
