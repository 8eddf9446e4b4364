"""The W8A8 decoder-layer stack of the int8 engine: four hand-written CUDA
kernels beside K1's, and their plain PyTorch versions.

Counterpart of the JAX package's `ops/fused_stack_int8.py`, whose Pallas
kernel `_layer_stack_int8_kernel` (TPU kernel K7) runs whole decoder
layers as `ops/fused_stack.py`'s K1 does, with the four large projections
(QKV, cross-attention Q, MLP expand and contract) in int8: per-row dynamic
symmetric int8 activations, per-output-channel int8 weights
(`pack_layer_stack_int8`), int32 accumulation and a float32
dequantization. Here a layer is eight launches of six kernels (sources in
`csrc/`, built by `ops/_build.py`):

  ln_gemm_i8       (csrc/gemm_i8.cu, its LayerNorm mode) LN1, LN2 or LN3
                   in float32 and its per-row int8 quantization in a
                   prologue over the batch's rows (then a grid-wide
                   barrier), then the int8 product: QKV and Q (out in the
                   compute dtype), expand (float32 + b1)
  dwconv_gelu_q8   (csrc/dwconv_gelu.cu) the 3x3 depthwise + dwb + exact
                   GELU of the float32 expanded hidden state, quantized per
                   pixel over all its channels (a thread-block cluster over
                   the channels, the maxima through distributed shared
                   memory): the contract product's int8 rows and scales,
                   the float32 GELU output never written
  gemm_i8          (csrc/gemm_i8.cu) int8 x int8 -> int32 on the tensor
                   cores with the dequantization epilogue: the contract
                   product, added with b2 into the float32 residual in place
  ln_gemm          K1's, the conditioning K/V projection (compute dtype)
  self_attention   K1's
  cross_attention  K1's, without its LN3 output (`ln=None`): ln_gemm_i8
                   takes LN3 of the updated residual in float32

`rowquant` (csrc/rowquant.cu), the per-row quantization on its own, is
not on the layer's path: the probe S1 (scripts/microbench_int8.py)
launches it, and both fused kernels share its arithmetic
(csrc/quant_row.cuh), so their int8 rows and scales are rowquant's bit
for bit.

Why LN3 is not fused into `cross_attention`: the int8 route quantizes
LN3's float32 output, not a bf16 one, so the LayerNorm feeds the
quantization directly, inside the product that reads the int8 rows.

Rounding points are the TPU kernel's (fused_stack_int8.py:48-102): LN1-3
outputs and the GELU output are quantized in float32, never rounded to
bf16 first; `rscale = max(max|y|, 1e-8) * (1/127)` and
`q = round_half_even(y * (1/rscale))`; products dequantize as
`float(acc) * rs * cs`; qkv and qc are rounded to the compute dtype; the
expanded hidden state stays float32 with `+ b1`; the contract adds
`(x + deq) + b2`; the conditioning K/V stays in the compute dtype. Weights
are quantized from the compute-dtype weights `pack_layer_stack` gives
(for bf16, the bf16-rounded weights).

Wrappers work as `ops/fused_stack.py`'s: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (counted in `LAUNCHES`), any
other device raises.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.ops._build import load_library
from transformer_latent_diffusion_tpu_torch.ops.fused_layer_vjp import _zeroed_counters

KERNELS = ("rowquant", "gemm_i8", "ln_gemm_i8", "dwconv_gelu_q8")
# launches of each kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# kernel launches per decoder layer, K1's kernels (counted in
# fused_stack.LAUNCHES) included
LAUNCHES_PER_LAYER = {"ln_gemm_i8": 3, "gemm_i8": 1, "dwconv_gelu_q8": 1,
                      "ln_gemm": 1, "self_attention": 1, "cross_attention": 1}
# the projections quantized to int8, and their scales' names
QUANTIZED = (("wqkv", "sqkv"), ("wq", "sq"), ("w1", "s1"), ("w2", "s2"))


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# ------------------------------ plain versions ------------------------------


def _symquant(x, dim: int):
    """Symmetric int8 quantization of float32 `x` along `dim`: (int8
    values, float32 scale max(max|x|, 1e-8) / 127 with `dim` kept)."""
    scale = x.abs().amax(dim, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    return torch.round(x * (1.0 / scale)).to(torch.int8), scale


def rowquant_plain(x, ln=None):
    """(q, rscale): the rows of x (M, K) quantized to int8, with their
    float32 scales (M, 1). ln: (scale, shift) float32 of a LayerNorm taken
    first (float32 statistics, eps 1e-5), or None."""
    return _symquant(x.float() if ln is None else fs._layer_norm_plain(x, ln), -1)


def gemm_i8_plain(xq, rs, wq, cs, bias=None, residual=None,
                  out_dtype=torch.bfloat16):
    """dequant(xq @ wq.T): xq (M, K) int8 with row scales rs (M, 1); wq
    (N, K) int8 with per-output-channel scales cs (1, N). The integer
    product is taken in float64, which is exact here (|sum| <= 127^2 K
    < 2^53) on any device, then rounded to float32 and scaled as
    (acc * rs) * cs. Without `residual`, returns (deq + bias) in
    `out_dtype`; with it, the float32 (residual + deq) + bias."""
    acc = (xq.double() @ wq.double().T).float()
    deq = acc * rs.reshape(-1, 1) * cs.reshape(1, -1)
    if residual is not None:
        out = residual + deq
        return out if bias is None else out + bias.reshape(-1)
    if bias is not None:
        deq = deq + bias.reshape(-1)
    return deq.to(out_dtype)


def ln_gemm_i8_plain(x, ln, wq, cs, bias=None, out_dtype=torch.bfloat16):
    """LN(x) quantized per row, then its int8 product: `rowquant_plain(x,
    ln)` and `gemm_i8_plain` on its rows. x: (M, K) float32; ln: (scale,
    shift) float32; wq (N, K) int8, cs (1, N), bias (N,) or None; returns
    (deq + bias) in `out_dtype`."""
    xq, rs = rowquant_plain(x, ln)
    return gemm_i8_plain(xq, rs, wq, cs, bias, out_dtype=out_dtype)


def dwconv_gelu_q8_plain(h, dw, dwb, hw: int):
    """(q, rscale): the float32 GELU(depthwise3x3(h) + dwb) of
    `fs.dwconv_gelu_plain` quantized per pixel over its channels by
    `rowquant_plain`. h: (B*hw*hw, C) float32; dw: (9, C) in the compute
    dtype; dwb: (C,) float32."""
    return rowquant_plain(fs.dwconv_gelu_plain(h, dw, dwb, hw, out_dtype=torch.float32))


# dwconv_gelu_q8's threads a block, and the least grid rows in its ring
Q8_THREADS = 384
Q8_MIN_SLOTS = 4


def dwconv_gelu_q8_plan(hw: int, c: int):
    """(ranks, tseg) of a `dwconv_gelu_q8` launch (pure: no device is
    touched). A cluster of `ranks` blocks (at most 8, the portable cluster
    size) splits each pixel's C channels into slices of whole 128-channel
    groups, so a warp's 32 lanes own 4 channels each of the same pixels,
    and a thread walks `tseg` pixels of a row (4 or 8). Of the layouts
    whose (slice / 4) x ceil(hw / tseg) threads fit the block's 384 and
    whose ring of 4 grid rows ((hw + 2) x slice float32 each) and maxima
    fit its shared memory (csrc/dwconv_gelu.cu, q8_smem_bytes), the one
    with the most threads at work, then the longer runs (fewer slab reads
    and sums a pixel; on an H100 the flagship's 4 ranks of 8-pixel runs
    took 0.224 ms a layer against 0.253 for 8 ranks of 4). Raises
    ValueError where none fits."""
    fs._require(c % 128 == 0 and c > 0 and hw > 0,
                f"dwconv_gelu_q8: needs C % 128 == 0, got C={c}")
    best = None
    for ranks in (8, 4, 2, 1):
        if c % (128 * ranks):
            continue
        piece = c // ranks
        for tseg in (8, 4):
            threads = piece // 4 * -(-hw // tseg)
            smem = (128 + Q8_MIN_SLOTS * (hw + 2) * piece * 4 + Q8_MIN_SLOTS * 8 + 8
                    + 3 * -(-hw // tseg) * (piece // 128) * tseg * 4)
            if threads <= Q8_THREADS and smem <= fs.SMEM_PER_BLOCK and hw + 2 <= 256:
                key = (threads, tseg, ranks)
                if best is None or key > best[0]:
                    best = (key, (ranks, tseg))
    fs._require(best is not None,
                f"dwconv_gelu_q8: a {hw}-wide grid of {c} channels takes no thread layout "
                f"or shared memory of a block")
    return best[1]


# ------------------------------ kernel wrappers ------------------------------


def rowquant(x, ln=None):
    """Kernel wrapper of `rowquant_plain`. On CUDA: x float32 (M, K) with
    K % 16 == 0 (the int8 rows' TMA maps in `gemm_i8`); ln float32 (K,)
    each, or None."""
    if x.device.type == "cpu":
        return rowquant_plain(x, ln)
    scale, shift = ln if ln is not None else (None, None)
    lnp = [t for t in (scale, shift) if t is not None]
    dev = fs._on_cuda("rowquant", x, *lnp)
    m, k = x.shape
    fs._require(x.dtype == torch.float32, "rowquant: x must be float32")
    fs._require(k % 16 == 0 and k > 0, f"rowquant: needs K % 16 == 0, got K={k}")
    fs._require(all(t.dtype == torch.float32 and t.numel() == k for t in lnp),
                "rowquant: LayerNorm scale/shift must be float32 (K,)")
    q = torch.empty((m, k), dtype=torch.int8, device=dev)
    rs = torch.empty((m, 1), dtype=torch.float32, device=dev)
    lib = load_library()
    LAUNCHES["rowquant"] += 1
    err = lib.ltd_rowquant(fs._ptr(x), fs._ptr(scale), fs._ptr(shift), fs._ptr(q),
                           fs._ptr(rs), m, k, fs._stream(dev))
    fs._check_launch(err, "rowquant")
    return q, rs


def gemm_i8(xq, rs, wq, cs, bias=None, residual=None, out_dtype=torch.bfloat16):
    """Kernel wrapper of `gemm_i8_plain` (same arguments and result; with
    `residual` the kernel updates it in place and returns it). On CUDA:
    xq, wq int8 with N % 16 == 0 and K % 16 == 0 (ragged last tiles are
    masked); rs, cs, bias and residual float32; out_dtype bf16 or
    float32."""
    if xq.device.type == "cpu":
        return gemm_i8_plain(xq, rs, wq, cs, bias, residual, out_dtype)
    extra = [t for t in (bias, residual) if t is not None]
    dev = fs._on_cuda("gemm_i8", xq, rs, wq, cs, *extra)
    m, k = xq.shape
    n = wq.shape[0]
    fs._require(xq.dtype == torch.int8 and wq.dtype == torch.int8
                and wq.shape == (n, k),
                f"gemm_i8: xq and wq must be int8, wq (N, {k}); got {xq.dtype}, "
                f"{wq.dtype} {tuple(wq.shape)}")
    fs._require(n % 16 == 0 and k % 16 == 0 and n > 0 and k > 0,
                f"gemm_i8: needs N % 16 == 0 and K % 16 == 0, got N={n} K={k}")
    fs._require(all(t.dtype == torch.float32 for t in (rs, cs, *extra)),
                "gemm_i8: rs, cs, bias and residual are float32")
    fs._require(rs.numel() == m and cs.numel() == n
                and (bias is None or bias.numel() == n),
                "gemm_i8: rs has M elements, cs and bias N")
    fs._require(out_dtype in (torch.bfloat16, torch.float32),
                "gemm_i8: out_dtype is bf16 or float32")
    out = None
    if residual is not None:
        fs._require(residual.shape == (m, n), "gemm_i8: residual must be (M, N)")
    else:
        out = torch.empty((m, n), dtype=out_dtype, device=dev)
    lib = load_library()
    LAUNCHES["gemm_i8"] += 1
    err = lib.ltd_gemm_i8(fs._ptr(xq), fs._ptr(rs), fs._ptr(wq), fs._ptr(cs),
                          fs._ptr(bias), fs._ptr(out), fs._ptr(residual), m, n, k,
                          int(out_dtype == torch.float32), fs._stream(dev))
    fs._check_launch(err, "gemm_i8")
    return residual if residual is not None else out


def ln_gemm_i8(x, ln, wq, cs, bias=None, out_dtype=torch.bfloat16):
    """Kernel wrapper of `ln_gemm_i8_plain` (same arguments and result),
    one launch. On CUDA: x float32 (M, K), ln float32 (K,) each, wq int8
    (N, K) with N % 16 == 0 and K % 16 == 0 (ragged last tiles are
    masked), cs and bias float32; out_dtype bf16 or float32."""
    if x.device.type == "cpu":
        return ln_gemm_i8_plain(x, ln, wq, cs, bias, out_dtype)
    scale, shift = ln
    extra = [t for t in (bias,) if t is not None]
    dev = fs._on_cuda("ln_gemm_i8", x, scale, shift, wq, cs, *extra)
    m, k = x.shape
    n = wq.shape[0]
    fs._require(x.dtype == torch.float32 and wq.dtype == torch.int8 and wq.shape == (n, k),
                f"ln_gemm_i8: x float32 (M, K), wq int8 (N, {k}); got {x.dtype}, "
                f"{wq.dtype} {tuple(wq.shape)}")
    fs._require(n % 16 == 0 and k % 16 == 0 and n > 0 and k > 0,
                f"ln_gemm_i8: needs N % 16 == 0 and K % 16 == 0, got N={n} K={k}")
    fs._require(all(t.dtype == torch.float32 for t in (scale, shift, cs, *extra))
                and scale.numel() == k and shift.numel() == k,
                "ln_gemm_i8: ln float32 (K,) each; cs and bias float32")
    fs._require(cs.numel() == n and (bias is None or bias.numel() == n),
                "ln_gemm_i8: cs and bias have N elements")
    fs._require(out_dtype in (torch.bfloat16, torch.float32),
                "ln_gemm_i8: out_dtype is bf16 or float32")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    # the prologue's int8 rows and scales, and the grid barrier's counters
    scratch = torch.empty((m, k), dtype=torch.int8, device=dev)
    rs = torch.empty((m, 1), dtype=torch.float32, device=dev)
    sync = _zeroed_counters(dev, 2)
    lib = load_library()
    LAUNCHES["ln_gemm_i8"] += 1
    err = lib.ltd_ln_gemm_i8(fs._ptr(x), fs._ptr(scale), fs._ptr(shift), fs._ptr(wq),
                             fs._ptr(cs), fs._ptr(bias), fs._ptr(out), fs._ptr(scratch),
                             fs._ptr(rs), fs._ptr(sync), m, n, k,
                             int(out_dtype == torch.float32), fs._stream(dev))
    fs._check_launch(err, "ln_gemm_i8")
    return out


def dwconv_gelu_q8(h, dw, dwb, hw: int):
    """Kernel wrapper of `dwconv_gelu_q8_plain` (same arguments and
    result), one launch. On CUDA: h float32 (B*hw*hw, C) with C % 128 == 0,
    dw (9, C) bf16 or float32 (the float32 compute dtype), dwb float32, and
    a grid that `dwconv_gelu_q8_plan` takes."""
    if h.device.type == "cpu":
        return dwconv_gelu_q8_plain(h, dw, dwb, hw)
    dev = fs._on_cuda("dwconv_gelu_q8", h, dw, dwb)
    m, c = h.shape
    fs._require(h.dtype == torch.float32 and dw.dtype in (torch.bfloat16, torch.float32)
                and dwb.dtype == torch.float32,
                "dwconv_gelu_q8: h float32, dw bf16 or float32, dwb float32")
    fs._require(m % (hw * hw) == 0 and dw.shape == (9, c) and dwb.numel() == c,
                "dwconv_gelu_q8: needs (B*hw*hw, C) rows, dw (9, C), dwb (C,)")
    ranks, tseg = dwconv_gelu_q8_plan(hw, c)
    q = torch.empty((m, c), dtype=torch.int8, device=dev)
    rs = torch.empty((m, 1), dtype=torch.float32, device=dev)
    lib = load_library()
    LAUNCHES["dwconv_gelu_q8"] += 1
    err = lib.ltd_dwconv_gelu_q8(fs._ptr(h), fs._ptr(dw), fs._ptr(dwb), fs._ptr(q),
                                 fs._ptr(rs), m // (hw * hw), hw, c, ranks, tseg,
                                 int(dw.dtype == torch.float32), fs._stream(dev))
    fs._check_launch(err, "dwconv_gelu_q8")
    return q, rs


# ------------------------------ the layer stack ------------------------------

_KERNEL_OPS = (ln_gemm_i8, gemm_i8, fs.ln_gemm, fs.self_attention,
               fs.cross_attention, dwconv_gelu_q8)
_PLAIN_OPS = (ln_gemm_i8_plain, gemm_i8_plain, fs.ln_gemm_plain,
              fs.self_attention_plain, fs.cross_attention_plain,
              dwconv_gelu_q8_plain)


def _layer_stack_int8(x, cond, stack, hw: int, n_heads: int, ops):
    lnq, qmm, gemm, sa, ca, dwq = ops
    b, n, d = x.shape
    mxu = stack["wkv"].dtype
    f32 = torch.float32
    # the float32 residual; a copy, since the kernels update it in place
    xres = x.reshape(b * n, d).to(f32, copy=True)
    c2 = cond.reshape(b * 2, d)
    for l in range(stack["wqkv"].shape[0]):
        def p(name):
            return stack[name][l]

        qkv = lnq(xres, (p("ln1s"), p("ln1b")), p("wqkv"), p("sqkv"), out_dtype=mxu)
        xres = sa(qkv, xres, n_heads, n)
        qc = lnq(xres, (p("ln2s"), p("ln2b")), p("wq"), p("sq"), out_dtype=mxu)
        kv = gemm(c2, p("wkv"))
        xres, _ = ca(qc, kv, xres, None, n_heads, n)
        hmat = lnq(xres, (p("ln3s"), p("ln3b")), p("w1"), p("s1"), bias=p("b1"),
                   out_dtype=f32)
        aq, ars = dwq(hmat, p("dw"), p("dwb"), hw)
        xres = qmm(aq, ars, p("w2"), p("s2"), bias=p("b2"), residual=xres)
    return xres.reshape(b, n, d).to(x.dtype)


def fused_layer_stack_int8(x, cond, stack: Mapping[str, torch.Tensor], hw: int,
                           n_heads: int):
    """Run the K stacked W8A8 decoder layers of `stack` (from
    `pack_layer_stack_int8`). x: (B, N, D) tokens; cond: (B, 2, D), both
    in the compute dtype. On CUDA every stage is a kernel; on the CPU
    every stage is its plain version."""
    return _layer_stack_int8(x, cond, stack, hw, n_heads, _KERNEL_OPS)


def fused_layer_stack_int8_plain(x, cond, stack: Mapping[str, torch.Tensor],
                                 hw: int, n_heads: int):
    """The plain PyTorch version of `fused_layer_stack_int8`, on any
    device."""
    return _layer_stack_int8(x, cond, stack, hw, n_heads, _PLAIN_OPS)


def colquant(w):
    """Per-output-channel symmetric int8 quantization of a projection in
    the (out, in) layout: (int8 (N, K), float32 scales (1, N)). The JAX
    package's `_colquant` of its (in, out) kernel, transposed."""
    wq, scale = _symquant(w.float(), -1)
    return wq, scale.reshape(1, -1)


def pack_layer_stack_int8(params: Mapping[str, torch.Tensor],
                          layer_indices: List[int], dtype) -> Dict[str, torch.Tensor]:
    """`fused_stack.pack_layer_stack`, then the four large projections
    (wqkv, wq, w1, w2) quantized per output channel from their `dtype`
    values, with their float32 scales (sqkv, sq, s1, s2: (K, 1, N))."""
    stack = fs.pack_layer_stack(params, layer_indices, dtype)
    for name, scale_name in QUANTIZED:
        pairs = [colquant(w) for w in stack[name]]
        stack[name] = torch.stack([q for q, _ in pairs]).contiguous()
        stack[scale_name] = torch.stack([s for _, s in pairs]).contiguous()
    return stack
