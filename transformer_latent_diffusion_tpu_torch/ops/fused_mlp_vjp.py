"""The hi-res sep-conv MLP, differentiable: TPU kernel K5's forward and
backward, each composed of hand-written CUDA kernels, and their plain
PyTorch versions.

Counterpart of the JAX package's `ops/fused_mlp_vjp.py`:
`fused_mlp_sepconv_vjp` (`_pallas_fwd`, :182-205, kernel `_fwd_kernel`,
:119-129) computes

    y = GELU(dw3x3(x W1 + b1) + dwb) W2 + b2

per image with the float32 hidden state h and the convolution's output c
in VMEM, the GELU output a rounded to the weights' dtype before the
contract product, y in x's dtype; its backward (`_pallas_bwd`, :208-246,
kernel `_bwd_kernel`, :135-179) recomputes h, c and a and returns dx, dW1,
db1, the 9 tap gradients, ddwb, dW2 and db2, with g, da's product operand
and dh rounded to the weights' dtype before their products. The linen path
runs it for a square grid of at most `FUSED_MLP_MAX_TOKENS` tokens
(models/blocks.py:184-210): at 512 px in serving, and in training on every
square grid of 256 < N <= 1024 tokens.

A Hopper SM cannot hold one image's float32 hidden state (1024 x 3072 x 4
bytes = 12.6 MB), so both passes are launches of the decoder layer's
kernels (`ops/fused_stack.py`, `ops/fused_stack_f32.py`,
`ops/fused_layer_vjp.py`), with h, c and the float32 gradient da in device
memory. The forward runs in the weights' dtype, bf16 or float32 (the JAX
package's default compute dtype, whose TPU kernel rounds nothing):

  forward   bf16 x and weights          float32 x and weights
            ln_gemm                     ln_gemm_f32 (3xTF32)
              h = x W1 + b1, float32      h = x W1 + b1, float32
            dwconv_gelu                 dwconv_gelu_f32
              a = bf16(GELU(dw3x3(h)      a = GELU(dw3x3(h) + dwb),
              + dwb)), row-band body      float32, row-band body at
              at hw = 32                  hw = 32
            ln_gemm                     ln_gemm_f32
              y = a W2 + b2 in x's        y = a W2 + b2, float32
              dtype
            (no residual: the block adds it outside, as the linen path does)
  backward  bf16 only (float32 training is ROADMAP item 7: on CUDA a
            float32 call that needs the gradient raises)
            ln_gemm, dwconv_gelu   the forward recomputed: h, and a with c
            weight_grad  dW2 = g^T a
            colsum       db2 = the column sums of the float32 g
            ln_gemm      da = g W2, float32 out
            dwconv_gelu_bwd  dc = da GELU'(c), the 9 tap sums, ddwb, db1 and
                         the bf16 dh, through its row-band body at hw = 32
            weight_grad  dW1 = dh^T x
            ln_gemm      dx = dh W1 in x's dtype

These are K2's backward kernels at the 1024-token shape. The float32 h, c
and da go to device memory and back (0.8 GB each per layer at batch 64),
traffic the TPU kernel avoids; fusing them over row bands is a later PR's
work. The GELU is the exact erf, where the TPU kernel uses a polynomial
(`_erf_poly`, within ~1e-7).

Weights are in the port's (out, in) layout: w1 (hidden, D), w2 (D,
hidden), dw (9, hidden) with tap di*3+dj; b1, dwb, b2 float32. The
gradients come back in the same layouts.
"""

from __future__ import annotations

from typing import Dict

import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

KERNELS = ("fused_mlp_sepconv", "fused_mlp_sepconv_f32", "fused_mlp_sepconv_bwd")
# calls that launched the kernels since the last reset_launch_counts(); the
# launches themselves count under their kernels' names: the bf16 forward's
# under "ln_gemm" (2 per call) and "dwconv_gelu" (1) in fused_stack.LAUNCHES,
# the float32 forward's under "ln_gemm_f32" (2) and "dwconv_gelu_f32" (1)
# in fused_stack_f32.LAUNCHES, the backward's under "ln_gemm" (3), "dwconv_gelu" (1) and, in
# fused_layer_vjp.LAUNCHES, "weight_grad" (2), "colsum" (1) and
# "dwconv_gelu_bwd" (1)
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


_KERNEL_OPS = (fs.ln_gemm, fs.dwconv_gelu, lv.weight_grad, lv.colsum,
               lv.dwconv_gelu_bwd)
_PLAIN_OPS = (fs.ln_gemm_plain, fs.dwconv_gelu_plain, lv.weight_grad_plain,
              lv.colsum_plain, lv.dwconv_gelu_bwd_plain)


def _mlp(x, w1, b1, dw, dwb, w2, b2, hw: int, ops):
    gemm, dwg = ops[:2]
    b, n, d = x.shape
    h = gemm(x.reshape(b * n, d), w1, bias=b1, out_dtype=torch.float32)
    a = dwg(h, dw, dwb, hw)
    return gemm(a, w2, bias=b2, out_dtype=x.dtype).reshape(b, n, d)


def _mlp_bwd(x, g, w1, b1, dw, dwb, w2, hw: int, ops):
    gemm, dwg, wgrad, csum, dwg_bwd = ops
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    g32 = g.reshape(b * n, d).float()
    g_lp = g32.to(w2.dtype)
    h = gemm(x2, w1, bias=b1, out_dtype=torch.float32)
    a, c = dwg(h, dw, dwb, hw, return_c=True)
    dw2 = wgrad(g_lp, a)
    db2 = csum(g32)
    del a
    # dY W: W read as stored (w_transposed), no transposed copy
    da = gemm(g_lp, w2, out_dtype=torch.float32, w_transposed=True)
    dh, ddw, ddwb, db1 = dwg_bwd(da, c, h, dw, hw)
    del da, c, h
    dw1 = wgrad(dh, x2)
    dx = gemm(dh, w1, out_dtype=x.dtype, w_transposed=True)
    return dx.reshape(b, n, d), dw1, db1, ddw, ddwb, dw2, db2


def fused_mlp_sepconv_plain(x, w1, b1, dw, dwb, w2, b2, hw: int):
    """GELU(dw3x3(x W1 + b1) + dwb) W2 + b2 on the hw x hw token grid of
    x (B, hw*hw, D): x rounded to the weights' dtype, float32 h and c, the
    exact GELU rounded to the weights' dtype, y in x's dtype."""
    return _mlp(x, w1, b1, dw, dwb, w2, b2, hw, _PLAIN_OPS)


def fused_mlp_sepconv_bwd_plain(x, g, w1, b1, dw, dwb, w2, hw: int):
    """The TPU kernel's `_bwd_kernel`, on the kernels' plain versions:
    (dx in x's dtype, dw1 (hidden, D), db1, ddw (9, hidden), ddwb,
    dw2 (D, hidden), db2), the parameter gradients float32. h, c and
    a = GELU(c) are recomputed in float32; dW2 = a^T g and da = g W2 from
    a and g rounded to the weights' dtype, db2 from the float32 g;
    dc = da GELU'(c); ddwb, the taps and dh (the flipped-tap correlation)
    float32; db1 from the float32 dh, dW1 and dx from dh rounded."""
    return _mlp_bwd(x, g, w1, b1, dw, dwb, w2, hw, _PLAIN_OPS)


def _require_cuda(name: str, x):
    fs._require(x.device.type == "cuda",
                f"{name}: the kernels run on CUDA tensors (CPU tensors take the "
                f"plain version); got {x.device}")


# what a float32 call that needs the MLP's gradient raises on CUDA
FLOAT32_GRAD = ("fused_mlp_sepconv: the float32 backward on CUDA is float32 "
                "training, not ported yet (ROADMAP item 7); train in bfloat16")


def _forward(x, w1, b1, dw, dwb, w2, b2, hw: int):
    if x.device.type == "cpu":
        return fused_mlp_sepconv_plain(x, w1, b1, dw, dwb, w2, b2, hw)
    _require_cuda("fused_mlp_sepconv", x)
    fs._require(x.dim() == 3 and x.shape[1] == hw * hw,
                f"fused_mlp_sepconv: x must be (B, {hw * hw}, D)")
    fs._require(x.dtype in (torch.bfloat16, torch.float32)
                and all(t.dtype == x.dtype for t in (w1, dw, w2)),
                "fused_mlp_sepconv: x, w1, dw and w2 must be all bf16 or all float32")
    y = _mlp(x.contiguous(), w1, b1, dw, dwb, w2, b2, hw, _KERNEL_OPS)
    LAUNCHES["fused_mlp_sepconv_f32" if x.dtype == torch.float32
             else "fused_mlp_sepconv"] += 1
    return y


def fused_mlp_sepconv_bwd(x, g, w1, b1, dw, dwb, w2, hw: int):
    """Kernel route of `fused_mlp_sepconv_bwd_plain` (same arguments and
    results): on CUDA the eight launches of the module docstring, x and g
    bf16 (B, hw*hw, D), the weights bf16; on CPU tensors the plain
    version."""
    if x.device.type == "cpu":
        return fused_mlp_sepconv_bwd_plain(x, g, w1, b1, dw, dwb, w2, hw)
    _require_cuda("fused_mlp_sepconv_bwd", x)
    if x.dtype == torch.float32:
        raise NotImplementedError(FLOAT32_GRAD)
    fs._require(x.dim() == 3 and x.shape[1] == hw * hw and g.shape == x.shape,
                f"fused_mlp_sepconv_bwd: x and g must be (B, {hw * hw}, D)")
    fs._require(x.dtype == torch.bfloat16 and g.dtype == torch.bfloat16,
                "fused_mlp_sepconv_bwd: x and g must be bf16")
    out = _mlp_bwd(x.contiguous(), g.contiguous(), w1, b1, dw, dwb, w2, hw,
                   _KERNEL_OPS)
    LAUNCHES["fused_mlp_sepconv_bwd"] += 1
    return out


class FusedMLPFunction(torch.autograd.Function):
    """The sep-conv MLP as an autograd function over the kernels (their
    plain versions on CPU tensors). The forward saves x and the weights
    only, as the TPU kernel's `_vjp_fwd` does; the backward recomputes.
    Gradients come back in each input's dtype. On CUDA float32 raises
    (ROADMAP item 7): the backward's kernels take bf16."""

    @staticmethod
    def forward(ctx, x, w1, b1, dw, dwb, w2, b2, hw: int):
        if x.device.type != "cpu":
            _require_cuda("fused_mlp_sepconv", x)
            if x.dtype == torch.float32:
                raise NotImplementedError(FLOAT32_GRAD)
        ctx.save_for_backward(x, w1, b1, dw, dwb, w2)
        ctx.hw, ctx.b2_dtype = hw, b2.dtype
        return _forward(x, w1, b1, dw, dwb, w2, b2, hw)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, dw, dwb, w2 = ctx.saved_tensors
        dx, dw1, db1, ddw, ddwb, dw2, db2 = fused_mlp_sepconv_bwd(
            x, g.contiguous(), w1, b1, dw, dwb, w2, ctx.hw)
        return (dx.to(x.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                ddw.to(dw.dtype), ddwb.to(dwb.dtype), dw2.to(w2.dtype),
                db2.to(ctx.b2_dtype), None)


def fused_mlp_sepconv(x, w1, b1, dw, dwb, w2, b2, hw: int):
    """Kernel route of `fused_mlp_sepconv_plain` (same arguments and
    result): on CUDA two `ln_gemm` launches and one `dwconv_gelu` launch,
    x and the weights bf16, or their float32 bodies (`ln_gemm_f32` twice,
    `dwconv_gelu_f32` once), x and the weights float32; on CPU tensors the
    plain version.
    Differentiable (`FusedMLPFunction`) where a gradient is asked for."""
    args = (x, w1, b1, dw, dwb, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedMLPFunction.apply(*args, hw)
    return _forward(*args, hw)
