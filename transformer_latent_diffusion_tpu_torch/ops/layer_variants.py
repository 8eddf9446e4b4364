"""The decoder-layer forward variants of the probe scripts/microbench_layer.py
(S4): one hand-written CUDA kernel, the compositions over K1's kernels,
and their plain PyTorch versions.

The JAX probe's `make_variant` / `_variant_kernel` runs the training
layer's forward (TPU kernel K2's `_fwd_kernel`) with two of its stages
swapped for variants, `attn_mode` x `dw_mode`:

  attn_mode  "base"     per-head softmax self-attention (the layer's own)
             "onehead"  one head as wide as D, scale still 1/sqrt(D/heads)
                        (wrong on purpose: it isolates the head loop), and
                        the 2-key cross-attention likewise
             "packed"   per-head scores, one row max over all heads' scores,
                        a per-head denominator
             "paired"   the same with the max shared by each pair of heads
  dw_mode    "base"     the 3x3 depthwise convolution
             "none"     no convolution: c = h + dwb
             "commuted" the convolution with its row taps first and its
                        column shifts last (the TPU kernel's order already)

Here the forward is `ops/fused_layer_vjp.py`'s composition of K1's four
kernels (the float32 hidden state h), with the self-attention stage taken
by `head_group_attention` (csrc/head_group_attention.cu: the group-shared
max for packed and paired, the summed heads for onehead), the
cross-attention by `cross_attention(summed=True)` for onehead, and the
depthwise stage by `dwconv_gelu(dw_mode=...)`. "base" x "base" is
`fused_layer_fwd` launch for launch.

Each wrapper runs its plain version on CPU tensors and otherwise checks
its inputs, launches the kernel or raises, and counts the launch.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.ops._build import load_library
from transformer_latent_diffusion_tpu_torch.ops.fused_stack import (
    _check_launch,
    _on_cuda,
    _ptr,
    _require,
    _stream,
)

ATTN_MODES = ("base", "onehead", "packed", "paired")

KERNELS = ("head_group_attention",)
# launches since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def attention_group(attn_mode: str, n_heads: int):
    """(group, summed) of `head_group_attention` for an attention mode:
    packed shares the max over all heads, paired over pairs, onehead sums
    the heads; base is a group of one (the layer's self_attention)."""
    _require(attn_mode in ATTN_MODES, f"attn_mode is one of {ATTN_MODES}")
    return {"base": (1, False), "onehead": (n_heads, True),
            "packed": (n_heads, False), "paired": (2, False)}[attn_mode]


def head_group_attention_plain(qkv, residual, n_heads: int, n_tokens: int,
                               group: int = 1, summed: bool = False):
    """residual + the variant's self-attention. qkv: (B*N, 3D) rows
    [q | k | v]; residual: (B*N, D) float32. Per-head float32 scores
    s = q k^T / sqrt(dh); summed: s summed over the heads (one head as
    wide as D), one softmax, its bf16 probabilities weighing all D columns
    of V; else e = exp(s - M) with M the row max over the `group` heads of
    each group, p = e / (the head's own sum of e), rounded to qkv's dtype,
    then P V per head in float32. A head whose scores all lie far below
    its group's max has a zero sum and a NaN output, as in the TPU
    variants."""
    m, three_d = qkv.shape
    d = three_d // 3
    b, dh = m // n_tokens, d // n_heads
    heads = qkv.reshape(b, n_tokens, 3, n_heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = heads[0].float(), heads[1].float(), heads[2].float()
    s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))   # (B, H, N, N)
    if summed:
        s = s.sum(1, keepdim=True)
        e = torch.exp(s - s.amax(-1, keepdim=True))
    else:
        s = s.reshape(b, n_heads // group, group, n_tokens, n_tokens)
        e = torch.exp(s - s.amax((2, 4), keepdim=True))
        e = e.reshape(b, n_heads, n_tokens, n_tokens)
    p = (e / e.sum(-1, keepdim=True)).to(qkv.dtype)
    o = p.float() @ v                                        # (B, H, N, dh)
    return residual + o.transpose(1, 2).reshape(m, d)


def head_group_attention(qkv, residual, n_heads: int, n_tokens: int,
                         group: int = 1, summed: bool = False):
    """Kernel wrapper of `head_group_attention_plain`; updates `residual`
    in place on CUDA. Needs head dim 64, N <= 256 (a ragged last 64-token
    tile is masked) and n_heads % group == 0."""
    if qkv.device.type == "cpu":
        return head_group_attention_plain(qkv, residual, n_heads, n_tokens,
                                          group, summed)
    dev = _on_cuda("head_group_attention", qkv, residual)
    m, three_d = qkv.shape
    d = three_d // 3
    _require(qkv.dtype == torch.bfloat16 and residual.dtype == torch.float32,
             "head_group_attention: qkv bf16, residual float32")
    _require(d == 64 * n_heads and residual.shape == (m, d),
             "head_group_attention: needs head dim 64 and residual (B*N, D)")
    _require(0 < n_tokens <= 256 and m % n_tokens == 0,
             f"head_group_attention: needs N <= 256 and (B*N) rows, got {n_tokens}")
    _require(summed or (group >= 1 and n_heads % group == 0),
             f"head_group_attention: {n_heads} heads in groups of {group}")
    lib = load_library()
    LAUNCHES["head_group_attention"] += 1
    err = lib.ltd_head_group_attention(_ptr(qkv), _ptr(residual), m // n_tokens,
                                       n_tokens, d, n_heads, group, int(summed),
                                       _stream(dev))
    _check_launch(err, "head_group_attention")
    return residual


def _self_attention_stage(attn_mode: str, n_heads: int, plain: bool):
    if attn_mode == "base":
        return fs.self_attention_plain if plain else fs.self_attention
    group, summed = attention_group(attn_mode, n_heads)
    fn = head_group_attention_plain if plain else head_group_attention
    return lambda qkv, res, h, n: fn(qkv, res, h, n, group, summed)


def _fwd_variant(attn_mode, dw_mode, x, cond, params, n_heads, hw, plain):
    _require(dw_mode in fs.DW_MODES, f"dw_mode is one of {fs.DW_MODES}")
    gemm = fs.ln_gemm_plain if plain else fs.ln_gemm
    cross = fs.cross_attention_plain if plain else fs.cross_attention
    dwconv = fs.dwconv_gelu_plain if plain else fs.dwconv_gelu
    attn = _self_attention_stage(attn_mode, n_heads, plain)
    (ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv,
     ln3s, ln3b, w1, b1, dw, dwb, w2, b2) = params
    b, n, d = x.shape
    # the float32 residual; a copy, since the kernels update it in place
    xres = x.reshape(b * n, d).to(torch.float32, copy=True)
    c2 = cond.reshape(b * 2, d).to(wqkv.dtype).contiguous()
    qkv = gemm(xres, wqkv, ln=(ln1s, ln1b))
    xres = attn(qkv, xres, n_heads, n)
    qc = gemm(xres, wq, ln=(ln2s, ln2b))
    kv = gemm(c2, wkv)
    xres, xn3 = cross(qc, kv, xres, (ln3s, ln3b), n_heads, n, attn_mode == "onehead")
    h = gemm(xn3, w1, bias=b1, out_dtype=torch.float32)
    a = dwconv(h, dw, dwb, hw, dw_mode=dw_mode)
    out = gemm(a, w2, bias=b2, residual=xres)
    return out.reshape(x.shape).to(x.dtype)


def fused_layer_fwd_variant(attn_mode: str, dw_mode: str, x, cond,
                            params: Sequence[torch.Tensor], n_heads: int, hw: int):
    """The training layer's forward with S4's variant stages, through the
    kernels (their plain versions on CPU tensors): x (B, N, D), cond
    (B, 2, D), params in PARAM_NAMES order (ops/fused_layer_vjp.py); the
    result in x's dtype."""
    return _fwd_variant(attn_mode, dw_mode, x, cond, params, n_heads, hw, plain=False)


def fused_layer_fwd_variant_plain(attn_mode: str, dw_mode: str, x, cond,
                                  params: Sequence[torch.Tensor], n_heads: int,
                                  hw: int):
    """The plain PyTorch version of `fused_layer_fwd_variant`, on any
    device: every stage its plain version."""
    return _fwd_variant(attn_mode, dw_mode, x, cond, params, n_heads, hw, plain=True)
