"""Multi-head attention, forward only: the flash-attention kernel (TPU
kernel K3) and its plain PyTorch version.

Counterpart of the forward half of the JAX package's `ops/attention.py`:
`_xla_attention` (the plain math), `_pallas_attention` / `_flash_kernel`
(K3: one program per (batch*head, 256-query block) with the whole K/V of
the head in VMEM and a float32 softmax) and `multi_head_attention`, which
takes the kernel for every attention with at least 8 queries and 8 keys
when `use_pallas` is set (`_pallas_ok`, :122-129). Tokens keep the JAX
package's (B, N, D) layout at the public function.

Here the kernel is `csrc/flash_attention.cu`: a Hopper SM cannot hold a
head's K and V at 1024-4096 tokens, so it streams them in 64-key tiles
with an online softmax. The wrapper hands it q, k and v as the (B*N, D)
row views they are (for self-attention, the three column blocks of the
fused QKV projection), without transposes, and it writes (B*N, D) rows.
On CPU tensors the wrapper runs `attention_plain`; on any other device
it launches the kernel or raises.

The backward (TPU kernels K4a/K4b) is not ported: asking the kernel route
on CUDA for a gradient raises NotImplementedError (ROADMAP 1d).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from transformer_latent_diffusion_tpu_torch.ops._build import load_library
from transformer_latent_diffusion_tpu_torch.ops.fused_stack import (
    _check_launch,
    _ptr,
    _require,
    _stream,
)

KERNELS = ("flash_attention",)
# launches of each kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# the kernel's head width (csrc/flash_attention.cu)
HEAD_DIM = 64
# the JAX package's gate (_pallas_ok): at least this many queries and keys
MIN_TOKENS = 8


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def attention_plain(q, k, v):
    """softmax(q k^T / sqrt(dh)) v per (batch, head), the JAX package's
    `_xla_attention`: float32 scores and softmax, the probabilities cast
    to v's dtype before they weigh V. q: (B, H, Nq, dh); k, v:
    (B, H, Nk, dh) -> (B, H, Nq, dh) in v's dtype."""
    dh = q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return p @ v


def _heads(x, n_heads: int):
    b, n, d = x.shape
    return x.reshape(b, n, n_heads, d // n_heads).transpose(1, 2)


def _merge(o):
    b, h, n, dh = o.shape
    return o.transpose(1, 2).reshape(b, n, h * dh)


def _mha_plain(q, k, v, n_heads: int):
    """`attention_plain` on (B, N, D) tokens, heads split and merged."""
    return _merge(attention_plain(_heads(q, n_heads), _heads(k, n_heads),
                                  _heads(v, n_heads)))


def _row_stride(name: str, t) -> int:
    """The element stride between consecutive token rows of a (B, N, D)
    view whose rows are evenly spaced across the batch."""
    b, n, d = t.shape
    _require(t.stride(2) == 1 and t.stride(0) == n * t.stride(1),
             f"flash_attention: {name} must be (B*N, row) rows with unit "
             f"column stride, got strides {t.stride()}")
    _require(t.stride(1) % 8 == 0 and t.data_ptr() % 16 == 0,
             f"flash_attention: {name}'s rows must be 16-byte aligned")
    return t.stride(1)


def flash_attention(q, k, v, n_heads: int):
    """Kernel wrapper of `attention_plain` on (B, N, D) tokens: returns
    (B, Nq, D) with the heads merged, like `multi_head_attention`.

    On CUDA: q, k, v bf16 with head dim 64, Nq and Nk >= 8, each a view
    of evenly spaced rows with unit column stride (the column blocks of a
    fused projection are); no gradient (K4 is not ported)."""
    if q.device.type == "cpu":
        return _mha_plain(q, k, v, n_heads)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: the kernel runs on CUDA tensors "
                         f"(CPU tensors take the plain version); got {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet: the attention backward "
            "kernels K4a/K4b wait for the hi-res training slice (ROADMAP 1d)")
    b, nq, d = q.shape
    nk = k.shape[1]
    for name, t in (("k", k), ("v", v)):
        _require(t.device == dev, f"flash_attention: {name} on {t.device}, q on {dev}")
    _require(all(t.dtype == torch.bfloat16 for t in (q, k, v)),
             "flash_attention: q, k and v must be bf16")
    _require(d == HEAD_DIM * n_heads and k.shape == (b, nk, d) and v.shape == k.shape,
             f"flash_attention: needs head dim {HEAD_DIM} and k, v (B, Nk, D)")
    _require(nq >= MIN_TOKENS and nk >= MIN_TOKENS,
             f"flash_attention: needs at least {MIN_TOKENS} queries and keys")
    strides = [_row_stride(name, t) for name, t in (("q", q), ("k", k), ("v", v))]
    out = torch.empty((b, nq, d), dtype=torch.bfloat16, device=dev)
    lib = load_library()
    LAUNCHES["flash_attention"] += 1
    err = lib.ltd_flash_attention(_ptr(q), _ptr(k), _ptr(v), _ptr(out), b, nq, nk,
                                  n_heads, *strides, _stream(dev))
    _check_launch(err, "flash_attention")
    return out


def multi_head_attention(q, k, v, n_heads: int, use_pallas: bool = False):
    """Head split + softmax(q k^T / sqrt(dh)) v + head merge, non-causal.
    q: (B, Nq, D); k, v: (B, Nk, D) -> (B, Nq, D).

    use_pallas: take the K3 kernel route (`flash_attention`) where the JAX
    package takes its Pallas kernel, at least 8 queries and keys and a
    head dim that is a multiple of 8; else the plain math."""
    dh = q.shape[-1] // n_heads
    if (use_pallas and q.shape[1] >= MIN_TOKENS and k.shape[1] >= MIN_TOKENS
            and dh % 8 == 0):
        return flash_attention(q, k, v, n_heads)
    return _mha_plain(q, k, v, n_heads)
