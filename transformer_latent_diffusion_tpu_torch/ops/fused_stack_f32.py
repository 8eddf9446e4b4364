"""The float32 bodies of the decoder-layer kernels: K1 and K7 with a
float32 compute dtype.

The JAX package's default configuration (`DenoiserLoad.dtype="float32"`)
runs its Pallas kernels `_layer_stack_kernel` (TPU kernel K1,
ops/fused_stack.py:120) and `_layer_stack_int8_kernel` (K7,
ops/fused_stack_int8.py:132) with float32 weights: every stage computes
in `mxu = weights.dtype`, so qkv, the cross-attention query and K/V, the
LN3 rows, the expanded hidden state, the taps and the GELU output stay
float32, the softmax probabilities are not rounded, and `_mm` multiplies
float32 operands with float32 accumulation. Hopper's tensor cores take
float32 only as TF32 (a 10-bit mantissa), so the two bodies that carry
the layer's products split each float32 operand into two TF32 parts and
run each product as three TF32 `wgmma` (3xTF32, csrc/hopper.cuh), at
float32 accuracy; the other two run on the CUDA cores:

  ln_gemm_f32          csrc/ln_gemm_f32.cu: TMA + 3xTF32 `wgmma` GEMM
                       (A split in registers, W split in shared memory
                       as it lands) with the LayerNorm prologue and the
                       bias / residual epilogue (the layer's five products).
                       The training layer's modes (the float32 LayerNorm
                       rows returned; W read transposed for dX = dY W) run
                       a split pre-pass of W into its TF32 parts, a row
                       pass for the rows, and the product on the parts,
                       in one call
  self_attention_f32   csrc/self_attention_f32.cu: TMA + 3xTF32 `wgmma`
                       per (batch, head, 64-query tile), K and V split by
                       the producer warps, the exact float32 softmax in
                       registers, added into the residual
  cross_attention_f32  csrc/cross_attention.cu's body on float32 qc, kv
                       and LN3 rows
  dwconv_gelu_f32      csrc/dwconv_gelu.cu's TMA body with float32 taps
                       (and, for the training layer, the float32 c)

The wrappers of `ops/fused_stack.py` (`ln_gemm`, `self_attention`,
`cross_attention`, `dwconv_gelu`) send a call whose weights or operands
are float32 here, so K1's stack and K7's run unchanged with float32
weights (K7's int8 kernels take the float32 compute dtype themselves:
`fused_stack_int8.ln_gemm_i8` gives float32 qkv and qc, and
`dwconv_gelu_q8` takes float32 taps). Each body counts its launches in this module's `LAUNCHES`,
apart from the bf16 bodies' counts. The plain versions are those of
`ops/fused_stack.py`, which take any dtype; CPU tensors run them.
"""

from __future__ import annotations

from typing import Dict

import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.ops._build import load_library

KERNELS = ("ln_gemm_f32", "self_attention_f32", "cross_attention_f32",
           "dwconv_gelu_f32")
# launches of each kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# kernel launches per decoder layer of K1 with float32 weights
LAUNCHES_PER_LAYER = {"ln_gemm_f32": 5, "self_attention_f32": 1,
                      "cross_attention_f32": 1, "dwconv_gelu_f32": 1}
# ... and of K7 (quantize="int8") with a float32 compute dtype: its int8
# kernels (ops/fused_stack_int8.LAUNCHES; dwconv_gelu_q8 with float32 taps)
# and the float32 bodies of its K/V product and attentions
LAUNCHES_PER_LAYER_INT8 = {"ln_gemm_i8": 3, "gemm_i8": 1, "dwconv_gelu_q8": 1,
                           "ln_gemm_f32": 1, "self_attention_f32": 1,
                           "cross_attention_f32": 1}
# launches of the training layer's modes (ops/fused_layer_vjp.py), each
# one also counted in LAUNCHES under its kernel
MODES = ("ln_gemm_f32 return_xn", "ln_gemm_f32 w_transposed", "dwconv_gelu_f32 return_c")
MODE_LAUNCHES: Dict[str, int] = {name: 0 for name in MODES}
F32 = torch.float32


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    for name in MODES:
        MODE_LAUNCHES[name] = 0


def launches_per_layer(dtype, quantize=None) -> Dict[str, int]:
    """The kernel launches of one decoder layer of the fused engine with
    `dtype` weights (bf16 or float32), K1's or, with quantize="int8",
    K7's."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack_int8 as q8

    if dtype == F32:
        return dict(LAUNCHES_PER_LAYER_INT8 if quantize else LAUNCHES_PER_LAYER)
    return dict(q8.LAUNCHES_PER_LAYER if quantize else fs.LAUNCHES_PER_LAYER)


def ln_gemm_f32(a, w, bias=None, ln=None, residual=None, return_xn=False,
                w_transposed=False):
    """`fs.ln_gemm_plain` for float32 a and w (N, K) on CUDA: float32 out,
    or the residual updated in place; with return_xn (and ln) also the
    float32 normalised rows; with w_transposed w is (K, N), read as stored
    (the training layer's dX = dY W; no LayerNorm). Needs N % 4 == 0,
    K % 8 == 0, contiguous 16-byte aligned operands."""
    scale, shift = ln if ln is not None else (None, None)
    extra = [t for t in (bias, scale, shift, residual) if t is not None]
    dev = fs._on_cuda("ln_gemm", a, w, *extra)
    m, k = a.shape
    n = w.shape[1] if w_transposed else w.shape[0]
    want = (k, n) if w_transposed else (n, k)
    fs._require(a.dtype == F32 and w.dtype == F32 and w.shape == want,
                f"ln_gemm: float32 w must be {want} with a float32 a")
    fs._require(n % 4 == 0 and k % 8 == 0,
                f"ln_gemm: float32 weights need N % 4 == 0 and K % 8 == 0, got N={n} K={k}")
    fs._require(all(t.dtype == F32 for t in extra),
                "ln_gemm: bias, ln and residual are float32")
    fs._require(bias is None or bias.numel() == n, "ln_gemm: bias must have N elements")
    fs._require(ln is None or (scale.numel() == k and shift.numel() == k),
                "ln_gemm: LayerNorm scale/shift must have K elements")
    fs._require(ln is not None or not return_xn, "ln_gemm: return_xn needs the LayerNorm prologue")
    fs._require(ln is None or not w_transposed,
                "ln_gemm: float32 w_transposed takes no LayerNorm prologue")
    if residual is not None:
        fs._require(residual.shape == (m, n), "ln_gemm: residual must be (M, N)")
        out = residual
    else:
        out = torch.empty((m, n), dtype=F32, device=dev)
    xn = torch.empty((m, k), dtype=F32, device=dev) if return_xn else None
    lib = load_library()
    LAUNCHES["ln_gemm_f32"] += 1
    MODE_LAUNCHES["ln_gemm_f32 return_xn"] += int(return_xn)
    MODE_LAUNCHES["ln_gemm_f32 w_transposed"] += int(w_transposed)
    err = lib.ltd_ln_gemm_f32(fs._ptr(a), fs._ptr(scale), fs._ptr(shift), fs._ptr(w),
                              fs._ptr(bias), fs._ptr(out), fs._ptr(xn), int(residual is not None),
                              m, n, k, int(w_transposed), fs._stream(dev))
    fs._check_launch(err, "ln_gemm_f32")
    return (out, xn) if return_xn else out


def self_attention_f32(qkv, residual, n_heads: int, n_tokens: int):
    """`fs.self_attention_plain` for float32 qkv on CUDA; updates
    `residual` in place. Needs head dim 64 and N <= 256."""
    dev = fs._on_cuda("self_attention", qkv, residual)
    m, three_d = qkv.shape
    d = three_d // 3
    fs._require(qkv.dtype == F32 and residual.dtype == F32,
                "self_attention: float32 qkv, float32 residual")
    fs._require(d == 64 * n_heads and residual.shape == (m, d),
                "self_attention: needs head dim 64 and residual (B*N, D)")
    fs._require(0 < n_tokens <= 256 and m % n_tokens == 0,
                f"self_attention: needs N <= 256 and (B*N) rows, got N={n_tokens}")
    lib = load_library()
    LAUNCHES["self_attention_f32"] += 1
    err = lib.ltd_self_attention_f32(fs._ptr(qkv), fs._ptr(residual), m // n_tokens,
                                     n_tokens, d, n_heads, fs._stream(dev))
    fs._check_launch(err, "self_attention_f32")
    return residual


def cross_attention_f32(qc, kv, residual, ln, n_heads: int, n_tokens: int):
    """`fs.cross_attention_plain` for float32 qc and kv on CUDA: the
    residual updated in place and the float32 LN3 rows (None when ln is
    None)."""
    scale, shift = ln if ln is not None else (None, None)
    lnp = [t for t in (scale, shift) if t is not None]
    dev = fs._on_cuda("cross_attention", qc, kv, residual, *lnp)
    m, d = qc.shape
    b = m // n_tokens
    fs._require(qc.dtype == F32 and kv.dtype == F32 and residual.dtype == F32
                and all(t.dtype == F32 and t.numel() == d for t in lnp),
                "cross_attention: float32 qc and kv; residual and ln (D,) float32")
    fs._require(d == 64 * n_heads and m == b * n_tokens
                and kv.shape == (2 * b, 2 * d) and residual.shape == (m, d),
                "cross_attention: needs head dim 64, kv (2B, 2D), residual (B*N, D)")
    xn = torch.empty((m, d), dtype=F32, device=dev) if ln is not None else None
    lib = load_library()
    LAUNCHES["cross_attention_f32"] += 1
    err = lib.ltd_cross_attention_f32(fs._ptr(qc), fs._ptr(kv), fs._ptr(residual),
                                      fs._ptr(scale), fs._ptr(shift), fs._ptr(xn), b,
                                      n_tokens, d, n_heads, fs._stream(dev))
    fs._check_launch(err, "cross_attention_f32")
    return residual, xn


def dwconv_gelu_f32(h, dw, dwb, hw: int, return_c=False):
    """`fs.dwconv_gelu_plain` for float32 h and taps on CUDA (base mode),
    float32 out, and with return_c the float32 pre-GELU values too (the
    training layer's recompute). Needs C % 64 == 0 and a grid that
    `fs.dwconv_gelu_body` holds in float32."""
    dev = fs._on_cuda("dwconv_gelu", h, dw, dwb)
    m, c = h.shape
    fs._require(h.dtype == F32 and dw.dtype == F32 and dwb.dtype == F32,
                "dwconv_gelu: float32 taps take float32 h and dwb")
    fs._require(c % fs.DW_CHUNK == 0 and m % (hw * hw) == 0
                and dw.shape == (9, c) and dwb.numel() == c,
                "dwconv_gelu: needs C % 64 == 0, (B*hw*hw, C) rows, dw (9, C), dwb (C,)")
    band = fs.dwconv_gelu_body(hw, F32)
    out = torch.empty((m, c), dtype=F32, device=dev)
    c_out = torch.empty((m, c), dtype=F32, device=dev) if return_c else None
    lib = load_library()
    LAUNCHES["dwconv_gelu_f32"] += 1
    MODE_LAUNCHES["dwconv_gelu_f32 return_c"] += int(return_c)
    err = lib.ltd_dwconv_gelu(fs._ptr(h), fs._ptr(dw), fs._ptr(dwb), fs._ptr(out), fs._ptr(c_out),
                              m // (hw * hw), hw, c, 1, 1, band, 0,
                              fs.DW_MODES.index("base"), 1, fs._stream(dev))
    fs._check_launch(err, "dwconv_gelu_f32")
    return (out, c_out) if return_c else out
