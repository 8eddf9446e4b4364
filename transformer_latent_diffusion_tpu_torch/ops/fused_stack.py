"""The decoder-layer stack of the fused engine: four hand-written CUDA
kernels and their plain PyTorch versions.

Counterpart of the JAX package's `ops/fused_stack.py`, whose Pallas
kernel `_layer_stack_kernel` runs whole decoder layers (LN1 -> QKV ->
self-attention -> +res -> LN2 -> Q, conditioning K/V -> 2-key
cross-attention -> +res -> LN3 -> expand -> 3x3 depthwise -> GELU ->
contract -> +res) with one layer's weights resident in TPU VMEM. A Hopper
SM has 227 KB of shared memory, not tens of MB, so here the layer is
split into four kernels (sources in `csrc/`, built by `ops/_build.py`):

  ln_gemm          LayerNorm prologue + bf16 tensor-core GEMM + bias or
                   residual epilogue (the layer's five products)
  self_attention   per-head softmax attention, added into the residual
  cross_attention  2-key softmax attention against the conditioning K/V,
                   added into the residual, then LN3 of the updated rows
                   (the expand product's bf16 input)
  dwconv_gelu      3x3 depthwise convolution + bias + exact GELU

Each kernel has a wrapper here that checks its inputs, allocates its
output with `torch.empty`, launches on the current stream, raises if the
launch failed, and counts its launches in `LAUNCHES`. A wrapper given CPU
tensors runs the kernel's plain version instead (`*_plain`, the math
written out with explicit matmuls and a float32 softmax); given a tensor
on any other device it raises. The plain versions are what the CPU tests
hold against the JAX kernel, and what the card's checks hold the kernels
against.

Rounding points are the TPU kernel's: the residual is float32 within a
call and cast to the input dtype at its end; qkv, the cross-attention
query and K/V, the expanded hidden state and the GELU output are rounded
to the weights' dtype (bf16) after float32 accumulation; softmax
probabilities are rounded to that dtype before they weigh V.

With float32 weights (the JAX package's default configuration) every one
of those is float32 and nothing is rounded: each wrapper sends such a
call to its float32 body (`ops/fused_stack_f32.py`: SIMT FFMA kernels on
the CUDA cores, since the tensor cores take float32 only as TF32), whose
launches count in that module's `LAUNCHES`.

The training layer (`ops/fused_layer_vjp.py`, TPU kernel K2) runs the same
kernels in three more modes: `ln_gemm(out_dtype=torch.float32)` (the
float32 hidden state, and the backward's dX = dY W products),
`ln_gemm(return_xn=True)` (also the bf16 normalised rows) and
`dwconv_gelu` on a float32 hidden state with `return_c=True` (also the
float32 pre-GELU values). The hi-res sep-conv MLP (`ops/fused_mlp_vjp.py`,
TPU kernel K5's forward) runs `dwconv_gelu` on a float32 hidden state at
hw = 32, which takes its row-band body (`dwconv_gelu_body`). The W8A8
stack (`ops/fused_stack_int8.py`, TPU kernel K7) runs `cross_attention`
without its LN3 output (`ln=None`) and `dwconv_gelu` with a float32
output (`out_dtype=torch.float32`). The probes of `scripts/` run
`cross_attention` with the heads summed into one (`summed=True`, the
"onehead" layer variant) and `dwconv_gelu` without the convolution or with
its shifts commuted (`dw_mode`) or with a bf16 pre-GELU output
(`c_dtype=torch.bfloat16`, the "bf16res" backward).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from transformer_latent_diffusion_tpu_torch.ops._build import load_library

LN_EPS = 1e-5

KERNELS = ("ln_gemm", "self_attention", "cross_attention", "dwconv_gelu")
# launches of each kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# kernel launches per decoder layer (5 products, 3 other stages)
LAUNCHES_PER_LAYER = {"ln_gemm": 5, "self_attention": 1,
                      "cross_attention": 1, "dwconv_gelu": 1}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# ------------------------------ plain versions ------------------------------


def _layer_norm_plain(x, ln):
    """Row LayerNorm in float32 (eps 1e-5); ln: (scale, shift) float32."""
    scale, shift = ln
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale.reshape(-1) \
        + shift.reshape(-1)


def ln_gemm_plain(a, w, bias=None, ln=None, residual=None, out_dtype=None,
                  return_xn=False, w_transposed=False):
    """LN?(a) @ w.T with float32 accumulation of w.dtype operands.

    a: (M, K); w: (N, K), or (K, N) with w_transposed (then a @ w); bias:
    (N,) float32; ln: (scale, shift) float32, statistics in float32 with
    eps 1e-5. Without `residual`, returns (acc + bias) rounded to
    `out_dtype` (default w.dtype); with it, returns the float32
    residual + (acc + bias), the TPU kernel's order. return_xn (with
    `ln`): returns (out, the normalised rows rounded to w.dtype)."""
    x = a.float() if ln is None else _layer_norm_plain(a, ln)
    xn = x.to(w.dtype)
    acc = xn.float() @ (w.float() if w_transposed else w.float().T)
    if residual is not None:
        out = residual + (acc if bias is None else acc + bias.reshape(-1))
    else:
        if bias is not None:
            acc = acc + bias.reshape(-1)
        out = acc.to(out_dtype or w.dtype)
    return (out, xn) if return_xn else out


def _softmax_pv(s, v, dtype):
    """float32 row softmax, probabilities rounded to `dtype`, then P @ V in
    float32. s: (..., Nq, Nk) float32; v: (..., Nk, dh)."""
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dtype)
    return p.float() @ v.float()


def self_attention_plain(qkv, residual, n_heads: int, n_tokens: int):
    """residual + softmax(q k^T / sqrt(dh)) v per head.
    qkv: (B*N, 3D) rows [q | k | v]; residual: (B*N, D) float32."""
    m, three_d = qkv.shape
    d = three_d // 3
    b, dh = m // n_tokens, d // n_heads
    heads = qkv.reshape(b, n_tokens, 3, n_heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = heads[0].float(), heads[1].float(), heads[2]
    s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    o = _softmax_pv(s, v, qkv.dtype)                     # (B, H, N, dh)
    return residual + o.transpose(1, 2).reshape(m, d)


def cross_attention_plain(qc, kv, residual, ln, n_heads: int, n_tokens: int,
                          summed: bool = False):
    """(x, xn): x = residual + 2-key softmax attention of qc against the
    conditioning K/V, and xn = LN(x) rounded to qc's dtype (None when ln
    is None, as the W8A8 stack asks).
    qc: (B*N, D); kv: (B*2, 2D) rows [k | v]; residual float32;
    ln: (scale, shift) float32, or None. summed: one head as wide as D
    with the scale 1/sqrt(D / n_heads) (the "onehead" layer variant of
    scripts/microbench_layer.py): the per-head scores summed over the
    heads, one softmax, its probabilities weighing every column of V."""
    m, d = qc.shape
    b, dh = m // n_tokens, d // n_heads
    q = qc.reshape(b, n_tokens, n_heads, dh).transpose(1, 2).float()
    kvh = kv.reshape(b, 2, 2, n_heads, dh).permute(2, 0, 3, 1, 4)
    k, v = kvh[0].float(), kvh[1]                          # (B, H, 2, dh)
    s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    if summed:  # every head takes the heads' summed scores
        s = s.sum(1, keepdim=True).expand(-1, n_heads, -1, -1)
    o = _softmax_pv(s, v, qc.dtype)
    x = residual + o.transpose(1, 2).reshape(m, d)
    return x, None if ln is None else _layer_norm_plain(x, ln).to(qc.dtype)


# the depthwise modes of `dwconv_gelu` (csrc/dwconv_gelu.cu's dw_mode)
DW_MODES = ("base", "none", "commuted")


def dwconv_gelu_plain(h, dw, dwb, hw: int, return_c=False, out_dtype=None,
                      dw_mode="base", c_dtype=None):
    """GELU(depthwise3x3(h) + dwb) on the hw x hw token grid, in float32,
    summed in the TPU kernel's order, rounded to `out_dtype` (default
    dw.dtype). h: (B*hw*hw, C); dw: (9, C) taps di*3+dj; dwb: (C,) float32.
    return_c: also return the pre-GELU values c, rounded to `c_dtype`
    (default float32). dw_mode "none": c = h + dwb, no convolution;
    "commuted" (scripts/microbench_layer.py's `_dw_fwd_commuted`: row taps
    first, then the column shifts) is the TPU kernel's order already, so
    its sums are base's."""
    m, c = h.shape
    g = h.float().reshape(m // (hw * hw), hw, hw, c)
    w = dw.float()
    if dw_mode == "none":
        acc = g
    else:
        pr = F.pad(g, (0, 0, 0, 0, 1, 1))                  # zero rows
        zs = [pr[:, 0:hw] * w[dj] + pr[:, 1:hw + 1] * w[3 + dj]
              + pr[:, 2:hw + 2] * w[6 + dj] for dj in range(3)]
        acc = (F.pad(zs[0], (0, 0, 1, 1))[:, :, 0:hw] + zs[1]
               + F.pad(zs[2], (0, 0, 1, 1))[:, :, 2:hw + 2])
    acc = acc + dwb.reshape(-1)
    act = 0.5 * acc * (1.0 + torch.erf(acc * (1.0 / math.sqrt(2.0))))
    act = act.reshape(m, c).to(out_dtype or dw.dtype)
    if return_c:
        return act, acc.reshape(m, c).to(c_dtype or torch.float32)
    return act


# ------------------------------ kernel wrappers ------------------------------


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _on_cuda(name: str, *tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors (CPU tensors "
                         f"take the plain version); got {dev}")
    for t in tensors:
        _require(t.device == dev, f"{name}: tensors on {t.device} and {dev}")
        _require(t.is_contiguous(), f"{name}: inputs must be contiguous")
        _require(t.data_ptr() % 16 == 0, f"{name}: inputs must be 16-byte aligned")
    return dev


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _stream(dev: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def tma_operand(t: torch.Tensor) -> bool:
    """Whether a TMA tensor map can address `t` as stored: contiguous and
    16-byte aligned."""
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _f32():
    """The float32 bodies (`ops/fused_stack_f32.py`, which imports this
    module)."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack_f32

    return fused_stack_f32


def ln_gemm(a, w, bias=None, ln=None, residual=None, out_dtype=None,
            return_xn=False, w_transposed=False):
    """Kernel wrapper of `ln_gemm_plain` (same arguments and result; with
    `residual` the kernel updates it in place and returns it).

    On CUDA: w bf16 (N, K), or (K, N) with w_transposed (read as stored,
    no copy), N % 8 == 0 (a ragged last column tile is masked) and
    K % 32 == 0; a float32 with `ln`, else bf16; bias, ln and residual
    float32; out_dtype bf16 or float32. Or w float32 (N, K) with a float32
    a, float32 out and N % 4 == 0, K % 8 == 0: the float32 body
    (`fused_stack_f32.ln_gemm_f32`)."""
    if a.device.type == "cpu":
        return ln_gemm_plain(a, w, bias, ln, residual, out_dtype, return_xn,
                             w_transposed)
    if w.dtype == torch.float32:
        _require(not (w_transposed or return_xn)
                 and out_dtype in (None, torch.float32),
                 "ln_gemm: float32 weights take (N, K) w and give float32 "
                 "out, no return_xn")
        return _f32().ln_gemm_f32(a, w, bias, ln, residual)
    scale, shift = ln if ln is not None else (None, None)
    extra = [t for t in (bias, scale, shift, residual) if t is not None]
    dev = _on_cuda("ln_gemm", a, w, *extra)
    m, k = a.shape
    n = w.shape[1] if w_transposed else w.shape[0]
    want = (k, n) if w_transposed else (n, k)
    _require(w.dtype == torch.bfloat16 and w.shape == want,
             f"ln_gemm: w must be bf16 or float32 {want}, got {w.dtype} "
             f"{tuple(w.shape)}")
    _require(n % 8 == 0 and k % 32 == 0,
             f"ln_gemm: needs N % 8 == 0 and K % 32 == 0, got N={n} K={k}")
    _require(a.dtype == (torch.float32 if ln is not None else torch.bfloat16),
             "ln_gemm: a is float32 with a LayerNorm prologue, else bf16")
    for t in extra:
        _require(t.dtype == torch.float32, "ln_gemm: bias, ln and residual "
                                           "are float32")
    out_dtype = out_dtype or torch.bfloat16
    _require(out_dtype in (torch.bfloat16, torch.float32),
             "ln_gemm: out_dtype is bf16 or float32")
    _require(ln is not None or not return_xn,
             "ln_gemm: return_xn needs the LayerNorm prologue")
    if bias is not None:
        _require(bias.numel() == n, "ln_gemm: bias must have N elements")
    if ln is not None:
        _require(scale.numel() == k and shift.numel() == k,
                 "ln_gemm: LayerNorm scale/shift must have K elements")
    out = None
    if residual is not None:
        _require(residual.shape == (m, n), "ln_gemm: residual must be (M, N)")
    else:
        out = torch.empty((m, n), dtype=out_dtype, device=dev)
    xn = (torch.empty((m, k), dtype=torch.bfloat16, device=dev)
          if return_xn else None)
    lib = load_library()
    # the LayerNorm prologue's bf16 rows, where xn does not hold them
    rows = lib.ltd_ln_gemm_scratch_rows(m, n, int(ln is not None), int(return_xn))
    scratch = (torch.empty((rows, k), dtype=torch.bfloat16, device=dev)
               if rows else None)
    LAUNCHES["ln_gemm"] += 1
    err = lib.ltd_ln_gemm(_ptr(a), _ptr(scale), _ptr(shift), _ptr(w),
                          _ptr(bias), _ptr(out), _ptr(residual), _ptr(xn),
                          _ptr(scratch), m, n, k, int(out_dtype == torch.float32),
                          int(w_transposed), _stream(dev))
    _check_launch(err, "ln_gemm")
    result = residual if residual is not None else out
    return (result, xn) if return_xn else result


def self_attention(qkv, residual, n_heads: int, n_tokens: int):
    """Kernel wrapper of `self_attention_plain`; updates `residual` in place
    on CUDA. Needs head dim 64, N <= 256 (a ragged last 64-token tile is
    masked in the kernel) and contiguous, 16-byte aligned qkv and
    residual (the kernel's TMA tensor maps). float32 qkv takes the float32
    body (`fused_stack_f32.self_attention_f32`)."""
    if qkv.device.type == "cpu":
        return self_attention_plain(qkv, residual, n_heads, n_tokens)
    if qkv.dtype == torch.float32:
        return _f32().self_attention_f32(qkv, residual, n_heads, n_tokens)
    dev = _on_cuda("self_attention", qkv, residual)
    m, three_d = qkv.shape
    d = three_d // 3
    _require(qkv.dtype == torch.bfloat16 and residual.dtype == torch.float32,
             "self_attention: qkv bf16 or float32, residual float32")
    _require(d == 64 * n_heads and residual.shape == (m, d),
             "self_attention: needs head dim 64 and residual (B*N, D)")
    _require(0 < n_tokens <= 256 and m % n_tokens == 0,
             f"self_attention: needs N <= 256 and (B*N) rows, got N={n_tokens}")
    _require(tma_operand(qkv) and tma_operand(residual),
             "self_attention: qkv and residual must be contiguous and 16-byte aligned")
    lib = load_library()
    LAUNCHES["self_attention"] += 1
    err = lib.ltd_self_attention(_ptr(qkv), _ptr(residual), m // n_tokens,
                                 n_tokens, d, n_heads, _stream(dev))
    _check_launch(err, "self_attention")
    return residual


def cross_attention(qc, kv, residual, ln, n_heads: int, n_tokens: int,
                    summed: bool = False):
    """Kernel wrapper of `cross_attention_plain`; on CUDA it updates
    `residual` in place and returns it with the new bf16 `xn` (None, and
    no LayerNorm, when ln is None). Needs head dim 64 (any number of
    heads). float32 qc and kv take the float32 body
    (`fused_stack_f32.cross_attention_f32`; not `summed`), whose xn is
    float32."""
    if qc.device.type == "cpu":
        return cross_attention_plain(qc, kv, residual, ln, n_heads, n_tokens,
                                     summed)
    if qc.dtype == torch.float32:
        _require(not summed, "cross_attention: summed takes bf16 qc and kv")
        return _f32().cross_attention_f32(qc, kv, residual, ln, n_heads,
                                          n_tokens)
    scale, shift = ln if ln is not None else (None, None)
    lnp = [t for t in (scale, shift) if t is not None]
    dev = _on_cuda("cross_attention", qc, kv, residual, *lnp)
    m, d = qc.shape
    b = m // n_tokens
    _require(qc.dtype == torch.bfloat16 and kv.dtype == torch.bfloat16
             and residual.dtype == torch.float32
             and all(t.dtype == torch.float32 and t.numel() == d for t in lnp),
             "cross_attention: qc and kv bf16 (or both float32); residual and "
             "ln (D,) float32")
    _require(d == 64 * n_heads and m == b * n_tokens
             and kv.shape == (2 * b, 2 * d) and residual.shape == (m, d),
             "cross_attention: needs head dim 64, kv (2B, 2D), residual (B*N, D)")
    xn = (torch.empty((m, d), dtype=torch.bfloat16, device=dev)
          if ln is not None else None)
    lib = load_library()
    LAUNCHES["cross_attention"] += 1
    err = lib.ltd_cross_attention(_ptr(qc), _ptr(kv), _ptr(residual),
                                  _ptr(scale), _ptr(shift), _ptr(xn), b,
                                  n_tokens, d, n_heads, int(summed),
                                  _stream(dev))
    _check_launch(err, "cross_attention")
    return residual, xn


# shared memory one block may use on the H100 (227 KB)
SMEM_PER_BLOCK = 232448
# dwconv_gelu's channels per block, and grid rows per block of its row-band body
DW_CHUNK = 64
DW_BAND_ROWS = 8


def dwconv_gelu_body(hw: int, dtype) -> int:
    """The `dwconv_gelu` body that holds an hw x hw grid of `dtype` rows:
    0 for the whole-grid body, whose (hw+2)^2 x 64 slab fits a block's
    shared memory (bf16 up to hw = 40, float32 up to 28), else the rows of
    a band of the row-band body, whose (rows+2) x (hw+2) x 64 slab does
    (float32 up to hw = 88, bf16 up to 179). Raises ValueError beyond."""
    item = torch.empty((), dtype=dtype).element_size()
    if (hw + 2) ** 2 * DW_CHUNK * item <= SMEM_PER_BLOCK:
        return 0
    if (DW_BAND_ROWS + 2) * (hw + 2) * DW_CHUNK * item <= SMEM_PER_BLOCK:
        return DW_BAND_ROWS
    raise ValueError(f"dwconv_gelu: a {hw} x {hw} grid of {dtype} rows exceeds "
                     f"the {SMEM_PER_BLOCK}-byte shared memory of both bodies")


def dwconv_gelu_route(hw: int, h_dtype, dw_mode: str = "base",
                      c_dtype=torch.float32) -> Tuple[str, int]:
    """The body of csrc/dwconv_gelu.cu that runs a `dwconv_gelu` call, and
    its band (pure: no device is touched): ("pointwise", 0) for dw_mode
    "none" (c = h + dwb reads no slab: any grid), else ("tma", band) with
    the band of `dwconv_gelu_body`; "commuted" is the TMA body's own
    float32 walk, so it runs base's code. "none" and "commuted" take
    float32 h and c, a bf16 c bf16 h. Raises ValueError on any other
    combination."""
    _require(dw_mode in DW_MODES, f"dwconv_gelu: dw_mode is one of {DW_MODES}")
    if dw_mode != "base":
        _require(h_dtype == torch.float32 and c_dtype == torch.float32,
                 f"dwconv_gelu: dw_mode {dw_mode!r} takes float32 h and c")
    _require(c_dtype in (torch.float32, torch.bfloat16)
             and (c_dtype == torch.float32 or h_dtype == torch.bfloat16),
             "dwconv_gelu: c is float32, or bf16 from bf16 h")
    if dw_mode == "none":
        return "pointwise", 0
    return "tma", dwconv_gelu_body(hw, h_dtype)


def dwconv_gelu(h, dw, dwb, hw: int, return_c=False, out_dtype=None,
                dw_mode="base", c_dtype=None):
    """Kernel wrapper of `dwconv_gelu_plain`. Needs C % 64 == 0 on CUDA;
    h bf16 or float32, dw bf16, dwb float32, out_dtype bf16 (the default)
    or float32, and the modes and grids that `dwconv_gelu_route` takes. Or
    dw float32 with a float32 h (base mode, no c, float32 out): the float32
    body (`fused_stack_f32.dwconv_gelu_f32`)."""
    _require(dw_mode in DW_MODES, f"dwconv_gelu: dw_mode is one of {DW_MODES}")
    if h.device.type == "cpu":
        return dwconv_gelu_plain(h, dw, dwb, hw, return_c, out_dtype, dw_mode,
                                 c_dtype)
    if dw.dtype == torch.float32:
        _require(dw_mode == "base" and not return_c and c_dtype is None
                 and out_dtype in (None, torch.float32),
                 "dwconv_gelu: float32 taps take the base mode, without c, "
                 "float32 out")
        return _f32().dwconv_gelu_f32(h, dw, dwb, hw)
    dev = _on_cuda("dwconv_gelu", h, dw, dwb)
    m, c = h.shape
    _require(h.dtype in (torch.bfloat16, torch.float32)
             and dw.dtype == torch.bfloat16 and dwb.dtype == torch.float32,
             "dwconv_gelu: h bf16 or float32, dw bf16 (or float32 with float32 "
             "h), dwb float32")
    _require(c % DW_CHUNK == 0 and m % (hw * hw) == 0
             and dw.shape == (9, c) and dwb.numel() == c,
             "dwconv_gelu: needs C % 64 == 0, (B*hw*hw, C) rows, dw (9, C), "
             "dwb (C,)")
    out_dtype = out_dtype or torch.bfloat16
    _require(out_dtype in (torch.bfloat16, torch.float32),
             "dwconv_gelu: out_dtype is bf16 or float32")
    c_dtype = c_dtype or torch.float32
    _, band = dwconv_gelu_route(hw, h.dtype, dw_mode, c_dtype)
    out = torch.empty((m, c), dtype=out_dtype, device=dev)
    c_out = (torch.empty((m, c), dtype=c_dtype, device=dev)
             if return_c else None)
    lib = load_library()
    LAUNCHES["dwconv_gelu"] += 1
    err = lib.ltd_dwconv_gelu(_ptr(h), _ptr(dw), _ptr(dwb), _ptr(out),
                              _ptr(c_out), m // (hw * hw), hw, c,
                              int(h.dtype == torch.float32),
                              int(out_dtype == torch.float32), band,
                              int(c_dtype == torch.bfloat16),
                              DW_MODES.index(dw_mode), 0, _stream(dev))
    _check_launch(err, "dwconv_gelu")
    return (out, c_out) if return_c else out


# ------------------------------ the layer stack ------------------------------

_KERNEL_OPS = (ln_gemm, self_attention, cross_attention, dwconv_gelu)
_PLAIN_OPS = (ln_gemm_plain, self_attention_plain, cross_attention_plain,
              dwconv_gelu_plain)


def _layer_stack(x, cond, stack, hw: int, n_heads: int, ops):
    gemm, sa, ca, dwg = ops
    b, n, d = x.shape
    # the float32 residual; a copy, since the kernels update it in place
    xres = x.reshape(b * n, d).to(torch.float32, copy=True)
    c2 = cond.reshape(b * 2, d)
    for l in range(stack["wqkv"].shape[0]):
        def p(name):
            return stack[name][l]

        qkv = gemm(xres, p("wqkv"), ln=(p("ln1s"), p("ln1b")))
        xres = sa(qkv, xres, n_heads, n)
        qc = gemm(xres, p("wq"), ln=(p("ln2s"), p("ln2b")))
        kv = gemm(c2, p("wkv"))
        xres, xn3 = ca(qc, kv, xres, (p("ln3s"), p("ln3b")), n_heads, n)
        hmat = gemm(xn3, p("w1"), bias=p("b1"))
        act = dwg(hmat, p("dw"), p("dwb"), hw)
        xres = gemm(act, p("w2"), bias=p("b2"), residual=xres)
    return xres.reshape(b, n, d).to(x.dtype)


def fused_layer_stack(x, cond, stack: Mapping[str, torch.Tensor], hw: int,
                      n_heads: int):
    """Run the K stacked decoder layers of `stack` (from `pack_layer_stack`).

    x: (B, N, D) tokens; cond: (B, 2, D) conditioning, both in the
    weights' dtype. On CUDA every stage is one of the four kernels; on
    the CPU every stage is its plain version."""
    return _layer_stack(x, cond, stack, hw, n_heads, _KERNEL_OPS)


def fused_layer_stack_plain(x, cond, stack: Mapping[str, torch.Tensor],
                            hw: int, n_heads: int):
    """The plain PyTorch version of `fused_layer_stack`, on any device."""
    return _layer_stack(x, cond, stack, hw, n_heads, _PLAIN_OPS)


def pack_layer_stack(params: Mapping[str, torch.Tensor],
                     layer_indices: List[int], dtype) -> Dict[str, torch.Tensor]:
    """Stack the weights of `layer_indices` along a new leading axis.

    params: a `Denoiser` state_dict (reference layout). Projections keep
    their (out, in) layout in `dtype`; the depthwise taps become (9, C)
    in `dtype` (tap di*3+dj); LayerNorm scale/shift and the biases are
    float32 rows (1, C)."""
    def layer(i):
        pre = f"denoiser_trans_block.decoder_blocks.{i}"

        def w(name):
            return params[f"{pre}.{name}"]

        def row(name):
            return w(name).float().reshape(1, -1)

        hidden = w("mlp.mlp.1.weight").shape[0]
        return {
            "ln1s": row("norm1.weight"), "ln1b": row("norm1.bias"),
            "wqkv": w("self_attention.qkv_linear.weight").to(dtype),
            "ln2s": row("norm2.weight"), "ln2b": row("norm2.bias"),
            "wq": w("cross_attention.q_linear.weight").to(dtype),
            "wkv": w("cross_attention.kv_linear.weight").to(dtype),
            "ln3s": row("norm3.weight"), "ln3b": row("norm3.bias"),
            "w1": w("mlp.mlp.0.weight")[:, :, 0, 0].to(dtype),
            "b1": row("mlp.mlp.0.bias"),
            "dw": w("mlp.mlp.1.weight").reshape(hidden, 9).T.to(dtype),
            "dwb": row("mlp.mlp.1.bias"),
            "w2": w("mlp.mlp.3.weight")[:, :, 0, 0].to(dtype),
            "b2": row("mlp.mlp.3.bias"),
        }

    per_layer = [layer(i) for i in layer_indices]
    return {key: torch.stack([pl[key] for pl in per_layer]).contiguous()
            for key in per_layer[0]}

