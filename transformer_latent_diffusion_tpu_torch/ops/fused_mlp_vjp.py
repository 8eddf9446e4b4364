"""The hi-res sep-conv MLP, forward only: TPU kernel K5's forward composed
of hand-written CUDA kernels, and its plain PyTorch version.

Counterpart of the forward half of the JAX package's
`ops/fused_mlp_vjp.py`: `fused_mlp_sepconv_vjp` (`_pallas_fwd`, :182-205,
kernel `_fwd_kernel`, :119-129) computes

    y = GELU(dw3x3(x W1 + b1) + dwb) W2 + b2

per image with the float32 hidden state h and the convolution's output c
in VMEM, the GELU output a rounded to the weights' dtype before the
contract product, y in x's dtype. The linen path runs it for a square grid
of at most `FUSED_MLP_MAX_TOKENS` tokens (models/blocks.py:184-210), which
the pipeline enables for 16 < hw <= 32, i.e. at 512 px.

A Hopper SM cannot hold one image's float32 hidden state (1024 x 3072 x 4
bytes = 12.6 MB), so the forward here is three launches of the decoder
layer's kernels (`ops/fused_stack.py`):

  ln_gemm      h = x W1 + b1, float32 out (its streaming mode, no LayerNorm)
  dwconv_gelu  a = bf16(GELU(dw3x3(h) + dwb)) on the float32 h, through its
               row-band body (the whole 34 x 34 x 64 float32 slab exceeds a
               block's shared memory at hw = 32)
  ln_gemm      y = a W2 + b2 in x's dtype, no residual (the block adds the
               residual outside, in bf16, as the linen path does)

The float32 h goes to device memory and back (0.8 GB each way per layer at
batch 64), traffic the TPU kernel avoids; fusing the three over row bands
is a later PR's work. The GELU is the exact erf, where the TPU kernel uses
a polynomial (`_erf_poly`, within ~1e-7).

Weights are in the port's (out, in) layout: w1 (hidden, D), w2 (D,
hidden), dw (9, hidden) with tap di*3+dj; b1, dwb, b2 float32.

The backward (K5's other half) waits for the hi-res training slice: on
CUDA, asking this route for a gradient raises NotImplementedError.
"""

from __future__ import annotations

from typing import Dict

import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

KERNELS = ("fused_mlp_sepconv",)
# calls that launched the kernels since the last reset_launch_counts(); the
# launches themselves count under "ln_gemm" (2 per call) and "dwconv_gelu"
# (1 per call) in fused_stack.LAUNCHES
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _mlp(x, w1, b1, dw, dwb, w2, b2, hw: int, gemm, dwg):
    b, n, d = x.shape
    h = gemm(x.reshape(b * n, d), w1, bias=b1, out_dtype=torch.float32)
    a = dwg(h, dw, dwb, hw)
    return gemm(a, w2, bias=b2, out_dtype=x.dtype).reshape(b, n, d)


def fused_mlp_sepconv_plain(x, w1, b1, dw, dwb, w2, b2, hw: int):
    """GELU(dw3x3(x W1 + b1) + dwb) W2 + b2 on the hw x hw token grid of
    x (B, hw*hw, D): x rounded to the weights' dtype, float32 h and c, the
    exact GELU rounded to the weights' dtype, y in x's dtype."""
    return _mlp(x, w1, b1, dw, dwb, w2, b2, hw, fs.ln_gemm_plain,
                fs.dwconv_gelu_plain)


def fused_mlp_sepconv(x, w1, b1, dw, dwb, w2, b2, hw: int):
    """Kernel route of `fused_mlp_sepconv_plain` (same arguments and
    result): on CUDA two `ln_gemm` launches and one `dwconv_gelu` launch,
    x and the weights bf16; on CPU tensors the plain version."""
    if x.device.type == "cpu":
        return fused_mlp_sepconv_plain(x, w1, b1, dw, dwb, w2, b2, hw)
    fs._require(x.device.type == "cuda",
                f"fused_mlp_sepconv: the kernels run on CUDA tensors (CPU "
                f"tensors take the plain version); got {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, dw, dwb, w2, b2)):
        raise NotImplementedError(
            "fused_mlp_sepconv has no backward yet: K5's backward waits for "
            "the hi-res training slice (ROADMAP 1d)")
    fs._require(x.dim() == 3 and x.shape[1] == hw * hw,
                f"fused_mlp_sepconv: x must be (B, {hw * hw}, D)")
    fs._require(x.dtype == torch.bfloat16, "fused_mlp_sepconv: x must be bf16")
    y = _mlp(x.contiguous(), w1, b1, dw, dwb, w2, b2, hw, fs.ln_gemm,
             fs.dwconv_gelu)
    LAUNCHES["fused_mlp_sepconv"] += 1
    return y
