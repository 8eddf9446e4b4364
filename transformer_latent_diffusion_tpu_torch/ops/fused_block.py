"""The decoder block's two inference halves as entry points (TPU kernels
K8 and K9), composed of K1's hand-written CUDA kernels, and their plain
PyTorch versions.

Counterpart of the JAX package's `ops/fused_block.py`, whose two Pallas
kernels keep one batch element's tokens in VMEM:

  `fused_attention_pair` (K8, `_attn_pair_kernel`; `pallas_call` at :141)
      x += SA(LN1 x); x += CA(LN2 x, cond), with the conditioning K and V
      projected outside: K6's forward with kv given;
  `fused_mlp_sepconv` (K9, `_mlp_kernel`; :215)
      x += Contract(GELU(DW3x3(Expand(LN3 x)))) on the square token grid:
      K1's MLP half.

Nothing in the JAX package calls them (its engine runs whole layers in
`fused_stack.py`), and nothing in the port does either: they are entry
points of `ops`. Here they are K1's kernels (`ops/fused_stack.py`):

  K8  ln_gemm          qkv = LN1(x) Wqkv^T
      self_attention   x1 = x + SA(qkv), the float32 residual
      ln_gemm          qc = LN2(x1) Wq^T
      cross_attention  x2 = x1 + CA(qc, [k_cond | v_cond]), no LN3
  K9  ln_gemm          h = bf16(LN3(x) W1^T + b1)
      dwconv_gelu      a = bf16(GELU(dw3x3(h) + dwb)), float32 sums
      ln_gemm          x + a W2^T + b2 (the residual epilogue)

Rounding points are the TPU kernels': K8's qkv and qc rounded to the
weights' dtype, p rounded before p v, the softmax in float32 with plain
sums; K9's h rounded after its bias (`fused_block.py:178`), the depthwise
sum in float32, the exact GELU rounded, the output in x's dtype. Two known
divergences from the TPU kernel, both below float32 rounding of the
output's scale: the GELU's erf is exact, where the TPU kernel uses
`_erf_poly` (|err| < 1.5e-7), and the kernel route adds the contract bias
after the residual, (x + a W2^T) + b2, where the TPU kernel and the plain
version here add x + (a W2^T + b2).

What bounds them on the H100 at the 256 px serving shapes (B = 64,
N = 256, D = 768, 12 heads, hidden 3072): K8's products, 0.10 TFLOP, and
K9's, 0.15 TFLOP, at the bf16 tensor peak (0.10 and 0.16 ms), above the
bytes they must move. Parameters use the port's layouts: projections
(out, in), the depthwise taps (9, hidden) with tap di*3+dj, LayerNorm
scales and shifts and the biases float32 vectors.
"""

from __future__ import annotations

from typing import Dict

import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

KERNELS = ("fused_block.fused_attention_pair", "fused_block.fused_mlp_sepconv")
# calls that launched the kernels since the last reset_launch_counts(); the
# launches themselves count under their kernels' names in
# fused_stack.LAUNCHES: K8's under "ln_gemm" (2), "self_attention" and
# "cross_attention", K9's under "ln_gemm" (2) and "dwconv_gelu"
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_KERNEL_OPS = (fs.ln_gemm, fs.self_attention, fs.cross_attention,
               fs.dwconv_gelu)
_PLAIN_OPS = (fs.ln_gemm_plain, fs.self_attention_plain,
              fs.cross_attention_plain, fs.dwconv_gelu_plain)


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _attention_pair(x, ln1s, ln1b, wqkv, ln2s, ln2b, wq, k_cond, v_cond,
                    n_heads: int, ops):
    gemm, sa, ca, _ = ops
    b, n, d = x.shape
    res = x.reshape(b * n, d).to(torch.float32, copy=True)
    qkv = gemm(res, wqkv, ln=(ln1s, ln1b))
    res = sa(qkv, res, n_heads, n)
    qc = gemm(res, wq, ln=(ln2s, ln2b))
    kv = torch.cat([k_cond, v_cond], -1).to(wq.dtype).reshape(2 * b, 2 * d)
    res, _ = ca(qc, kv, res, None, n_heads, n)
    return res.reshape(b, n, d).to(x.dtype)


def fused_attention_pair_plain(x, ln1s, ln1b, wqkv, ln2s, ln2b, wq, k_cond,
                               v_cond, n_heads: int):
    """The TPU kernel's `_attn_pair_kernel`, written out on K1's plain
    versions: x (B, N, D); k_cond, v_cond (B, 2, D); wqkv (3D, D), wq
    (D, D); the result in x's dtype."""
    return _attention_pair(x, ln1s, ln1b, wqkv, ln2s, ln2b, wq, k_cond,
                           v_cond, n_heads, _PLAIN_OPS)


def fused_attention_pair(x, ln1s, ln1b, wqkv, ln2s, ln2b, wq, k_cond, v_cond,
                         n_heads: int):
    """x after x += SA(LN1 x); x += CA(LN2 x, cond), the cond K/V given
    (the JAX package's `fused_attention_pair`). On CUDA four launches (the
    module docstring), x, the projections and k_cond, v_cond bf16, at most
    256 tokens; on CPU tensors `fused_attention_pair_plain`."""
    args = (x, ln1s, ln1b, wqkv, ln2s, ln2b, wq, k_cond, v_cond)
    if x.device.type == "cpu":
        return fused_attention_pair_plain(*args, n_heads)
    fs._require(x.device.type == "cuda",
                f"fused_attention_pair: the kernels run on CUDA tensors (CPU "
                f"tensors take the plain version); got {x.device}")
    fs._require(x.dim() == 3 and k_cond.shape == v_cond.shape
                == (x.shape[0], 2, x.shape[2]),
                "fused_attention_pair: x (B, N, D), k_cond and v_cond (B, 2, D)")
    out = _attention_pair(*args, n_heads, _KERNEL_OPS)
    LAUNCHES["fused_block.fused_attention_pair"] += 1
    return out


def _mlp_hidden(x, lns, lnb, w1, b1, dw, dwb, hw: int, ops):
    """(the float32 residual rows, the bf16 GELU output a)."""
    gemm, _, _, dwg = ops
    b, n, d = x.shape
    res = x.reshape(b * n, d).to(torch.float32, copy=True)
    h = gemm(res, w1, bias=b1, ln=(lns, lnb))
    return res, dwg(h, dw, dwb, hw)


def fused_mlp_sepconv_plain(x, ln_scale, ln_bias, w1, b1, dw, dwb, w2, b2,
                            hw: int):
    """The TPU kernel's `_mlp_kernel`, written out on K1's plain versions:
    x (B, hw*hw, D); w1 (hidden, D), w2 (D, hidden), dw (9, hidden); the
    result in x's dtype."""
    res, a = _mlp_hidden(x, ln_scale, ln_bias, w1, b1, dw, dwb, hw, _PLAIN_OPS)
    # the TPU kernel's order: x + (a W2^T + b2)
    out = res + fs.ln_gemm_plain(a, w2, bias=b2, out_dtype=torch.float32)
    return out.reshape(x.shape).to(x.dtype)


def fused_mlp_sepconv(x, ln_scale, ln_bias, w1, b1, dw, dwb, w2, b2, hw: int):
    """x + MLPSepConv(LN3 x) on the hw x hw grid (the JAX package's
    `fused_block.fused_mlp_sepconv`). On CUDA three launches (the module
    docstring), x and the weights bf16; on CPU tensors
    `fused_mlp_sepconv_plain`."""
    args = (x, ln_scale, ln_bias, w1, b1, dw, dwb, w2, b2)
    if x.device.type == "cpu":
        return fused_mlp_sepconv_plain(*args, hw)
    fs._require(x.device.type == "cuda",
                f"fused_mlp_sepconv: the kernels run on CUDA tensors (CPU "
                f"tensors take the plain version); got {x.device}")
    fs._require(x.dim() == 3 and x.shape[1] == hw * hw,
                f"fused_mlp_sepconv: x must be (B, {hw * hw}, D)")
    res, a = _mlp_hidden(x, ln_scale, ln_bias, w1, b1, dw, dwb, hw, _KERNEL_OPS)
    out = fs.ln_gemm(a, w2, bias=b2, residual=res)
    LAUNCHES["fused_block.fused_mlp_sepconv"] += 1
    return out.reshape(x.shape).to(x.dtype)
