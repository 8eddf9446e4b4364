"""The differentiable attention pair of the training step (TPU kernel K6):
its bf16 route through `csrc/attn_pair.cu`, and its plain PyTorch versions.

Counterpart of the JAX package's `ops/fused_attn_vjp.py`, whose two
Pallas kernels compute, per batch element,

    x1 = x + SelfAttn(LN1 x)
    x2 = x1 + CrossAttn(LN2 x1, cond)       (cond's K/V projected inside)

forward in one kernel (`_fwd_kernel`, :103; `pallas_call` at :255), and
backward in one kernel (`_bwd_kernel`, :138; :276) that recomputes the
forward internals in VMEM and returns dx, dcond and the seven parameter
gradients, accumulating the weight gradients across its sequential batch
grid. The JAX `DecoderBlock` runs it in training for a block of at most
256 tokens that K2 does not take (`models/blocks.py:269-284,327-355`):
the FFN is not the sep-conv MLP (`mlp_class` "mlp" or "moe"), the grid
is not square, or `fused_attn_vjp` asks for it.

The bf16 route (bf16 x, cond and projections) keeps the TPU kernel's
intermediates out of device memory where it can (`csrc/attn_pair.cu`'s
header has the design):

  forward   pair_qkv            qkv = LN1(x) Wqkv^T from x's bf16 rows
            ln_gemm             kv = cond Wkv^T
            self_attention_x1   x1 = x + SA(qkv), float32
            pair_cross_fwd      x2 = x1 + CA(LN2(x1) Wq^T, kv), bf16; qc
                                stays in registers
  backward  pair_qkv            the recompute: qkv, xn1, LN1's statistics
            ln_gemm             kv
            self_attention_x1   x1
            pair_cross_bwd      xn2, LN2's statistics, dqc, and the tiles'
                                dkv sums, which pair_dkv adds into dkv
            weight_grad (2)     dWkv = dkv^T cond, dWq = dqc^T xn2
            ln_gemm             dcond = dkv Wkv, bf16
            pair_ln_bwd         dx1 = g + LN2's backward of dqc Wq
            self_attention_bwd  dqkv from dx1
            weight_grad         dWqkv = dqkv^T xn1
            pair_ln_bwd         dx = dx1 + LN1's backward of dqkv Wqkv, bf16
            colsum              dLN1, dLN2 from the row tiles' partials

Four launches forward and thirteen backward (`ROUTE_LAUNCHES`), where
K2's helpers (`ops/fused_layer_vjp.py`) took five and eighteen; no aten
pass runs between them. Every sum has an order fixed by the shapes.

Rounding points are the TPU kernel's: qkv, qc and kv rounded to the
weights' dtype after float32 accumulation; the softmax in float32 with p
rounded before p v; in the backward the per-head slices of g and dx1,
ds, dqc, dkv and dqkv rounded before their products; every sum float32;
dx in x's dtype, dcond in cond's and each parameter gradient cast to its
parameter's dtype (`_vjp_bwd`, :328-340). The TPU kernel sums the
softmax denominator with a float32 ones-matmul (`_rowsum_mxu`); here it is
a float32 sum, which differs in order only.

With float32 weights (float32 training) the pair runs K2's composition
over the float32 bodies of its kernels (`ops/fused_stack_f32.py`,
`ops/fused_layer_vjp_f32.py`; `composite_fwd` / `composite_bwd`), and
nothing is rounded; the launches count under those bodies' names.

`fused_attention_pair_fwd_plain` / `fused_attention_pair_bwd_plain` write
the TPU kernels out in one piece; each kernel of the route has its plain
version here (`*_plain`), which its wrapper runs for CPU tensors, so the
route on CPU tensors runs the plain versions in the kernels' layouts.
`fused_attention_pair_vjp` (an autograd function, `FusedAttnPairFunction`)
runs the route for CUDA tensors, or raises. Parameters use the port's
(reference torch) layouts: projections (out, in), LayerNorm scales and
shifts as vectors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.ops._build import load_library
from transformer_latent_diffusion_tpu_torch.ops.fused_stack import (
    _check_launch,
    _on_cuda,
    _ptr,
    _require,
    _stream,
)

PARAM_NAMES = lv.PARAM_NAMES[:7]

# the route's own kernels (csrc/attn_pair.cu, and self_attention.cu's X1
# body); "pair_dkv" is the second launch of a pair_cross_bwd call
ROUTE_KERNELS = ("pair_qkv", "self_attention_x1", "pair_cross_fwd",
                 "pair_cross_bwd", "pair_dkv", "pair_ln_bwd")
KERNELS = ("fused_attention_pair_vjp", "fused_attention_pair_vjp_bwd") + ROUTE_KERNELS
# kernel launches since the last reset_launch_counts(), and the calls of
# the two entry points that launched them ("fused_attention_pair_vjp",
# "..._bwd"); the route's other launches count under "ln_gemm" in
# fused_stack.LAUNCHES and "weight_grad", "self_attention_bwd" and
# "colsum" in fused_layer_vjp.LAUNCHES
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# one bf16 call of each entry point, by kernel
ROUTE_LAUNCHES = {
    "forward": {"pair_qkv": 1, "ln_gemm": 1, "self_attention_x1": 1, "pair_cross_fwd": 1},
    "backward": {"pair_qkv": 1, "ln_gemm": 2, "self_attention_x1": 1, "pair_cross_bwd": 1,
                 "pair_dkv": 1, "weight_grad": 3, "pair_ln_bwd": 2,
                 "self_attention_bwd": 1, "colsum": 1},
}
# rows of csrc/attn_pair.cu's output tiles, over which its partial sums run
BM = 128


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _count(name: str) -> None:
    LAUNCHES[name] += 1


def pair_slots(n_tokens: int) -> int:
    """The most batch elements of n_tokens rows that one BM-row tile
    spans: the partial sums of dkv a tile keeps."""
    return (n_tokens - 1 + BM - 1) // n_tokens + 1


def _tile_sums(t, index, n_out):
    """Rows of t (M, C) float32 summed into n_out rows by index (M,)."""
    out = torch.zeros((n_out, t.shape[1]), dtype=torch.float32, device=t.device)
    return out.index_add_(0, index, t)


# ------------------------------ the kernels, plain ------------------------------


def pair_qkv_plain(x, ln_s, ln_b, w):
    """(qkv (M, 3D) in w's dtype, xn (M, D) in w's dtype, stats (M, 2)
    float32 (mean, rstd)) of LN1 -> QKV from the rows x (M, D)."""
    xf = x.float()
    xn, _, rstd = lv._ln_fwd(xf, ln_s.float(), ln_b.float())
    lp = w.dtype
    return (lv._mm(xn, w.T, lp).to(lp), xn.to(lp),
            torch.cat([xf.mean(-1, keepdim=True), rstd], -1))


def self_attention_x1_plain(qkv, x, n_heads: int, n_tokens: int):
    """x1 = x + self-attention of the qkv rows, float32 (M, D)."""
    return fs.self_attention_plain(qkv, x.float(), n_heads, n_tokens)


def pair_cross_fwd_plain(x1, ln_s, ln_b, wq, kv, n_heads: int, n_tokens: int):
    """x2 = x1 + CA(LN2(x1) Wq^T, kv) in wq's dtype: x1 (M, D) float32, kv
    (2B, 2D) rows [k | v] of each element's two conditioning tokens."""
    qc = fs.ln_gemm_plain(x1, wq, ln=(ln_s, ln_b))
    x2, _ = fs.cross_attention_plain(qc, kv, x1.float(), None, n_heads, n_tokens)
    return x2.to(wq.dtype)


def pair_cross_bwd_plain(x1, ln_s, ln_b, wq, kv, g, n_heads: int, n_tokens: int):
    """The recompute's LN2 -> Q with the 2-key cross-attention's backward
    from g (M, D) at x2: (dqc (M, D), xn2 (M, D), both in wq's dtype, stats
    (M, 2) (mean, rstd) of LN2, part) where part ((M / BM rounded up) *
    pair_slots(N) * 2, 2D) float32 holds, for row tile t, element slot s
    (element t * BM // N + s) and key j, that tile's sum over its rows of
    that element of [dk_j | dv_j], as the kernel keeps them."""
    qc, xn2, stats = pair_qkv_plain(x1, ln_s, ln_b, wq)
    m, d = qc.shape
    b = m // n_tokens
    lp = qc.dtype
    q = lv._heads(qc.float().reshape(b, n_tokens, d), n_heads)
    k, v = (lv._heads(t.float().reshape(b, 2, d), n_heads) for t in kv.split(d, -1))
    scale = 1.0 / math.sqrt(d // n_heads)
    p = lv._softmax_rows(lv._mm(q, k.transpose(-1, -2), lp) * scale)   # (B, H, N, 2)
    gh = lv._heads(g.float().reshape(b, n_tokens, d), n_heads)
    dp = lv._mm(gh, v.transpose(-1, -2), lp)
    ds = (lv._softmax_bwd(p, dp) * scale).to(lp).float()
    dqc = lv._merge(ds @ k).reshape(m, d).to(lp)
    # each row's [dk_j | dv_j] (M, 2, 2D), then the tiles' sums per element
    dk = ds.unsqueeze(-1) * q.unsqueeze(-2)                     # (B, H, N, 2, dh)
    dv = p.to(lp).float().unsqueeze(-1) * gh.unsqueeze(-2)

    def rows(t):  # (B, H, N, 2, dh) -> (M, 2, D)
        return t.permute(0, 2, 3, 1, 4).reshape(m, 2, d)

    per_row = torch.cat([rows(dk), rows(dv)], -1).reshape(m, 4 * d)
    slots = pair_slots(n_tokens)
    r = torch.arange(m, device=qc.device)
    tile = r // BM
    index = tile * slots + r // n_tokens - (tile * BM) // n_tokens
    part = _tile_sums(per_row, index, -(-m // BM) * slots)
    return dqc, xn2, stats, part.reshape(-1, 2 * d)


def pair_dkv_plain(part, b: int, n_tokens: int, d: int, dtype=torch.bfloat16):
    """dkv (2B, 2D) in `dtype`: element e's rows 2e + j the sum, over the
    row tiles that hold its tokens in tile order, of their partials
    (`pair_cross_bwd_plain`'s part)."""
    slots = pair_slots(n_tokens)
    tiles = part.shape[0] // (2 * slots)
    blocks = part.reshape(tiles, slots, 2 * 2 * d)
    out = torch.zeros((b, 2 * 2 * d), dtype=torch.float32, device=part.device)
    for t in range(tiles):
        first = t * BM // n_tokens
        last = min((t + 1) * BM, b * n_tokens) - 1
        for e in range(first, last // n_tokens + 1):
            out[e] += blocks[t, e - first]
    return out.reshape(2 * b, 2 * d).to(dtype)


def pair_ln_bwd_plain(dy, w, x, stats, scale, upstream, out_dtype):
    """(out, part): out = upstream + the LayerNorm backward of dxn = dy W
    (dy (M, K), w (K, N) as stored) for the LayerNorm of x (M, N) with its
    stats (M, 2) (mean, rstd) and scale (N,), in out_dtype; part (M / BM
    rounded up, 2N) float32 the row tiles' sums of [dxn xhat | dxn]."""
    lp = w.dtype
    dxn = lv._mm(dy, w, lp)
    xhat = (x.float() - stats[:, :1]) * stats[:, 1:]
    dx, _, _ = lv._ln_bwd(dxn, xhat, stats[:, 1:], scale.float())
    m = dy.shape[0]
    part = _tile_sums(torch.cat([dxn * xhat, dxn], 1),
                      torch.arange(m, device=dy.device) // BM, -(-m // BM))
    return (upstream.float() + dx).to(out_dtype), part


# ------------------------------ kernel wrappers ------------------------------


def _require_ln(name, x, ln_s, ln_b, w, n_out):
    m, d = x.shape
    _require(x.dtype == torch.bfloat16 or name != "pair_qkv", f"{name}: x must be bf16")
    _require(w.dtype == torch.bfloat16 and w.shape == (n_out, d),
             f"{name}: w must be bf16 ({n_out}, {d})")
    _require(ln_s.dtype == ln_b.dtype == torch.float32 and ln_s.numel() == ln_b.numel() == d,
             f"{name}: LayerNorm scale and shift float32 ({d},)")
    _require(d % 64 == 0 and 64 <= d <= 1024,
             f"{name}: D a multiple of 64 and at most 1024, got {d}")


def _scratch(lib, m, n, d, cross, keep, dev):
    rows = lib.ltd_pair_scratch_rows(m, n, int(cross), int(keep))
    return torch.empty((rows, d), dtype=torch.bfloat16, device=dev) if rows else None


def pair_qkv(x, ln_s, ln_b, w, keep: bool = False):
    """Kernel wrapper of `pair_qkv_plain`: (qkv, xn, stats), xn and stats
    None unless keep (the backward's recompute). On CUDA x (M, D) and w
    (3D, D) bf16, D % 64 == 0, D <= 1024."""
    if x.device.type == "cpu":
        qkv, xn, stats = pair_qkv_plain(x, ln_s, ln_b, w)
        return (qkv, xn, stats) if keep else (qkv, None, None)
    dev = _on_cuda("pair_qkv", x, ln_s, ln_b, w)
    m, d = x.shape
    _require_ln("pair_qkv", x, ln_s, ln_b, w, 3 * d)
    qkv = torch.empty((m, 3 * d), dtype=torch.bfloat16, device=dev)
    xn = torch.empty((m, d), dtype=torch.bfloat16, device=dev) if keep else None
    stats = torch.empty((m, 2), dtype=torch.float32, device=dev) if keep else None
    lib = load_library()
    scratch = _scratch(lib, m, 3 * d, d, False, keep, dev)
    _count("pair_qkv")
    _check_launch(lib.ltd_pair_qkv(_ptr(x), _ptr(ln_s), _ptr(ln_b), _ptr(w), _ptr(qkv),
                                   _ptr(xn), _ptr(stats), _ptr(scratch), m, d, _stream(dev)),
                  "pair_qkv")
    return qkv, xn, stats


def self_attention_x1(qkv, x, n_heads: int, n_tokens: int):
    """Kernel wrapper of `self_attention_x1_plain` (csrc/self_attention.cu's
    X1 body). On CUDA qkv (B*N, 3D) and x (B*N, D) bf16, head dim 64, N <=
    256."""
    if qkv.device.type == "cpu":
        return self_attention_x1_plain(qkv, x, n_heads, n_tokens)
    dev = _on_cuda("self_attention_x1", qkv, x)
    m, d = x.shape
    _require(qkv.dtype == x.dtype == torch.bfloat16 and qkv.shape == (m, 3 * d)
             and d == 64 * n_heads and 0 < n_tokens <= 256 and m % n_tokens == 0,
             "self_attention_x1: qkv (B*N, 3D) and x (B*N, D) bf16, head dim 64, N <= 256")
    x1 = torch.empty((m, d), dtype=torch.float32, device=dev)
    lib = load_library()
    _count("self_attention_x1")
    _check_launch(lib.ltd_self_attention_x1(_ptr(qkv), _ptr(x), _ptr(x1), m // n_tokens,
                                            n_tokens, d, n_heads, _stream(dev)),
                  "self_attention_x1")
    return x1


def _require_cross(name, x1, kv, n_heads, n_tokens):
    m, d = x1.shape
    _require(x1.dtype == torch.float32 and kv.dtype == torch.bfloat16
             and d == 64 * n_heads and m % n_tokens == 0
             and kv.shape == (2 * (m // n_tokens), 2 * d),
             f"{name}: x1 (B*N, D) float32, kv (2B, 2D) bf16, head dim 64")


def pair_cross_fwd(x1, ln_s, ln_b, wq, kv, n_heads: int, n_tokens: int):
    """Kernel wrapper of `pair_cross_fwd_plain`: x2 (B*N, D) bf16."""
    if x1.device.type == "cpu":
        return pair_cross_fwd_plain(x1, ln_s, ln_b, wq, kv, n_heads, n_tokens)
    dev = _on_cuda("pair_cross_fwd", x1, ln_s, ln_b, wq, kv)
    m, d = x1.shape
    _require_ln("pair_cross_fwd", x1, ln_s, ln_b, wq, d)
    _require_cross("pair_cross_fwd", x1, kv, n_heads, n_tokens)
    x2 = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    lib = load_library()
    scratch = _scratch(lib, m, d, d, True, False, dev)
    _count("pair_cross_fwd")
    _check_launch(lib.ltd_pair_cross_fwd(_ptr(x1), _ptr(ln_s), _ptr(ln_b), _ptr(wq), _ptr(kv),
                                         _ptr(x2), _ptr(scratch), m, d, n_tokens, _stream(dev)),
                  "pair_cross_fwd")
    return x2


def pair_cross_bwd(x1, ln_s, ln_b, wq, kv, g, n_heads: int, n_tokens: int):
    """(dqc, xn2, stats, dkv): `pair_cross_bwd_plain` with its partials
    added by `pair_dkv_plain` (two launches on CUDA: the product with the
    cross-attention's backward, then the partials' sums). On CUDA g (B*N,
    D) bf16."""
    m, d = x1.shape
    b = m // n_tokens
    if x1.device.type == "cpu":
        dqc, xn2, stats, part = pair_cross_bwd_plain(x1, ln_s, ln_b, wq, kv, g, n_heads,
                                                     n_tokens)
        return dqc, xn2, stats, pair_dkv_plain(part, b, n_tokens, d, wq.dtype)
    dev = _on_cuda("pair_cross_bwd", x1, ln_s, ln_b, wq, kv, g)
    _require_ln("pair_cross_bwd", x1, ln_s, ln_b, wq, d)
    _require_cross("pair_cross_bwd", x1, kv, n_heads, n_tokens)
    _require(g.dtype == torch.bfloat16 and g.shape == (m, d),
             "pair_cross_bwd: g (B*N, D) bf16")
    slots = pair_slots(n_tokens)
    bf = torch.bfloat16
    dqc = torch.empty((m, d), dtype=bf, device=dev)
    xn2 = torch.empty((m, d), dtype=bf, device=dev)
    dkv = torch.empty((2 * b, 2 * d), dtype=bf, device=dev)
    stats = torch.empty((m, 2), dtype=torch.float32, device=dev)
    part = torch.empty((-(-m // BM) * slots * 2, 2 * d), dtype=torch.float32, device=dev)
    lib = load_library()
    scratch = _scratch(lib, m, d, d, True, True, dev)
    _count("pair_cross_bwd")
    _count("pair_dkv")
    _check_launch(lib.ltd_pair_cross_bwd(_ptr(x1), _ptr(ln_s), _ptr(ln_b), _ptr(wq), _ptr(kv),
                                         _ptr(g), _ptr(dqc), _ptr(xn2), _ptr(stats), _ptr(part),
                                         _ptr(dkv), _ptr(scratch), m, d, n_tokens, slots,
                                         _stream(dev)),
                  "pair_cross_bwd")
    return dqc, xn2, stats, dkv


def pair_ln_bwd(dy, w, x, stats, scale, upstream, out_dtype, part, col0: int):
    """Kernel wrapper of `pair_ln_bwd_plain`: returns out and writes the
    partials into part[:, col0:col0 + 2N] (part (M / BM rounded up, C)
    float32). On CUDA dy (M, K), w (K, N) bf16, N % 64 == 0, N <= 1024;
    either x float32, upstream bf16 and out_dtype float32 (LN2's), or x
    bf16, upstream float32 and out_dtype bf16 (LN1's)."""
    if dy.device.type == "cpu":
        out, sums = pair_ln_bwd_plain(dy, w, x, stats, scale, upstream, out_dtype)
        part[:, col0:col0 + sums.shape[1]] = sums
        return out
    dev = _on_cuda("pair_ln_bwd", dy, w, x, stats, scale, upstream, part)
    m, k = dy.shape
    n = w.shape[1]
    ln2 = x.dtype == torch.float32
    _require(dy.dtype == w.dtype == torch.bfloat16 and w.shape[0] == k
             and x.shape == upstream.shape == (m, n) and stats.shape == (m, 2)
             and scale.dtype == torch.float32 and scale.numel() == n
             and n % 64 == 0 and 64 <= n <= 1024 and k % 64 == 0,
             "pair_ln_bwd: dy (M, K), w (K, N) bf16, x and upstream (M, N), stats (M, 2), "
             "scale (N,) float32, N % 64 == 0, N <= 1024, K % 64 == 0")
    want = ((torch.float32, torch.bfloat16, torch.float32) if ln2
            else (torch.bfloat16, torch.float32, torch.bfloat16))
    _require((x.dtype, upstream.dtype, out_dtype) == want,
             "pair_ln_bwd: x, upstream, out float32, bf16, float32 or bf16, float32, bf16")
    _require(part.dtype == torch.float32 and part.shape[0] == -(-m // BM)
             and col0 + 2 * n <= part.shape[1], "pair_ln_bwd: part (M / 128, >= col0 + 2N)")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    lib = load_library()
    _count("pair_ln_bwd")
    _check_launch(lib.ltd_pair_ln_bwd(_ptr(dy), _ptr(w), _ptr(x), _ptr(stats), _ptr(scale),
                                      _ptr(upstream), _ptr(out),
                                      ctypes.c_void_p(part.data_ptr() + 4 * col0),
                                      part.shape[1], m, n, k, int(ln2), _stream(dev)),
                  "pair_ln_bwd")
    return out


# ------------------------------ the route ------------------------------


def route_fwd(x, cond, params, n_heads: int):
    """x2 (B, N, D) bf16 through the route's four kernels (module
    docstring); x, cond and the projections bf16."""
    ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv = params
    b, n, d = x.shape
    x_rows = x.reshape(b * n, d)
    qkv, _, _ = pair_qkv(x_rows, ln1s, ln1b, wqkv)
    kv = fs.ln_gemm(cond.reshape(2 * b, d), wkv)
    x1 = self_attention_x1(qkv, x_rows, n_heads, n)
    return pair_cross_fwd(x1, ln2s, ln2b, wq, kv, n_heads, n).reshape(b, n, d)


def route_bwd(x, cond, g, params, n_heads: int):
    """(dx (B, N, D) bf16, dcond (B, 2, D) bf16, the seven parameter
    gradients float32, flat) through the route's thirteen kernels."""
    ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv = params
    b, n, d = x.shape
    m = b * n
    x_rows, c_rows, g_rows = x.reshape(m, d), cond.reshape(2 * b, d), g.reshape(m, d)
    qkv, xn1, stats1 = pair_qkv(x_rows, ln1s, ln1b, wqkv, keep=True)
    kv = fs.ln_gemm(c_rows, wkv)
    x1 = self_attention_x1(qkv, x_rows, n_heads, n)
    dqc, xn2, stats2, dkv = pair_cross_bwd(x1, ln2s, ln2b, wq, kv, g_rows, n_heads, n)
    dwkv = lv.weight_grad(dkv, c_rows)
    dcond = fs.ln_gemm(dkv, wkv, out_dtype=cond.dtype, w_transposed=True)
    dwq = lv.weight_grad(dqc, xn2)
    # the row tiles' [dln1s | dln1b | dln2s | dln2b] partials, one colsum
    part = torch.empty((-(-m // BM), 4 * d), dtype=torch.float32, device=x.device)
    dx1 = pair_ln_bwd(dqc, wq, x1, stats2, ln2s, g_rows, torch.float32, part, 2 * d)
    dqkv = lv.self_attention_bwd(qkv, dx1, n_heads, n)
    dwqkv = lv.weight_grad(dqkv, xn1)
    dx = pair_ln_bwd(dqkv, wqkv, x_rows, stats1, ln1s, dx1, x.dtype, part, 0)
    ds1, db1, ds2, db2 = lv.colsum(part).split(d)
    return dx, dcond, [ds1, db1, dwqkv, ds2, db2, dwq, dwkv]


def composite_fwd(x, cond, params, n_heads: int):
    """The pair through K2's helpers (`fused_layer_vjp._attn_pair_forward`):
    the float32 route, and the bf16 composite this module's route replaced
    (its A/B yardstick, `scripts/attn_pair_ab.py`)."""
    r = lv._attn_pair_forward(x.contiguous(), cond.contiguous(), params, n_heads,
                              keep=False)
    return r["x2"].reshape(x.shape).to(x.dtype)


def composite_bwd(x, cond, g, params, n_heads: int):
    """`composite_fwd`'s backward with its recompute: (dx, dcond in their
    inputs' dtypes, the seven float32 gradients, flat)."""
    b, n, d = x.shape
    r = lv._attn_pair_forward(x.contiguous(), cond.contiguous(), params, n_heads,
                              keep=True)
    dx, dcond, grads = lv._attn_pair_bwd(r, g.reshape(b * n, d).float(), params, n_heads, n)
    return dx.reshape(b, n, d).to(x.dtype), dcond.reshape(b, 2, d).to(cond.dtype), grads


# ------------------------------ the pair ------------------------------


def fused_attention_pair_fwd_plain(x, cond, ln1s, ln1b, wqkv, ln2s, ln2b, wq,
                                   wkv, n_heads: int):
    """The TPU kernel's `_fwd_kernel`, written out: x (B, N, D), cond
    (B, 2, D); x2 in x's dtype."""
    r = lv._attn_pair_residuals(x, cond, (ln1s, ln1b, wqkv, ln2s, ln2b, wq,
                                          wkv), n_heads)
    return r["x2"].to(x.dtype)


def fused_attention_pair_bwd_plain(x, cond, g, ln1s, ln1b, wqkv, ln2s, ln2b,
                                   wq, wkv, n_heads: int):
    """The TPU kernel's `_bwd_kernel`, written out: (dx in x's dtype, dcond
    in cond's dtype, then dln1s, dln1b, dwqkv, dln2s, dln2b, dwq, dwkv in
    float32, shaped like their parameters)."""
    params = (ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv)
    r = lv._attn_pair_residuals(x, cond, params, n_heads)
    dx, dcond, grads = lv._attn_pair_bwd_plain(r, g.float(), params, n_heads)
    return (dx.to(x.dtype), dcond.to(cond.dtype),
            *(gr.reshape(p.shape) for gr, p in zip(grads, params)))


def _require_cuda(name: str, x, cond):
    fs._require(x.device.type == "cuda",
                f"{name}: the kernels run on CUDA tensors (CPU tensors take the "
                f"plain versions); got {x.device}")
    fs._require(x.dim() == 3 and cond.shape == (x.shape[0], 2, x.shape[2]),
                f"{name}: x must be (B, N, D) and cond (B, 2, D)")


def _bf16_inputs(*tensors) -> bool:
    return all(t.dtype == torch.bfloat16 for t in tensors)


def _bf16_route(name: str, x, cond, wqkv) -> bool:
    """True for the bf16 route (bf16 projections, and then bf16 x and
    cond); False for float32 projections (the float32 bodies)."""
    if wqkv.dtype == torch.float32:
        return False
    fs._require(x.dtype == cond.dtype == wqkv.dtype == torch.bfloat16,
                f"{name}: the bf16 route takes bf16 x, cond and projections, got "
                f"{x.dtype}, {cond.dtype}, {wqkv.dtype}")
    return True


def fused_attention_pair_fwd(x, cond, ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv,
                             n_heads: int):
    """Kernel route of `fused_attention_pair_fwd_plain` (same arguments and
    result). CUDA tensors: with bf16 x, cond and projections (LayerNorm
    parameters float32) the route's four launches, with float32 ones the
    float32 bodies. CPU tensors: the route's plain versions (bf16 x, cond
    and projections), else the plain pair."""
    params = (ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv)
    if x.device.type == "cpu":
        if not _bf16_inputs(x, cond, wqkv):
            return fused_attention_pair_fwd_plain(x, cond, *params, n_heads)
        return route_fwd(x, cond, params, n_heads)
    name = "fused_attention_pair_vjp"
    _require_cuda(name, x, cond)
    if _bf16_route(name, x, cond, wqkv):
        out = route_fwd(x.contiguous(), cond.contiguous(), params, n_heads)
    else:
        out = composite_fwd(x, cond, params, n_heads)
    LAUNCHES[name] += 1
    return out


def fused_attention_pair_bwd(x, cond, g, ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv,
                             n_heads: int):
    """Kernel route of `fused_attention_pair_bwd_plain` (same arguments and
    results): on CUDA the route's thirteen launches (bf16; g bf16 too), or
    the float32 bodies; on CPU tensors the route's plain versions (bf16 x,
    cond, g and projections), else the plain pair."""
    params = (ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv)
    if x.device.type == "cpu":
        if not _bf16_inputs(x, cond, wqkv, g):
            return fused_attention_pair_bwd_plain(x, cond, g, *params, n_heads)
        dx, dcond, grads = route_bwd(x, cond, g, params, n_heads)
    else:
        name = "fused_attention_pair_vjp (backward)"
        _require_cuda(name, x, cond)
        if _bf16_route(name, x, cond, wqkv):
            fs._require(g.dtype == torch.bfloat16,
                        f"{name}: the bf16 route takes a bf16 upstream gradient")
            dx, dcond, grads = route_bwd(x.contiguous(), cond.contiguous(), g.contiguous(),
                                         params, n_heads)
        else:
            dx, dcond, grads = composite_bwd(x, cond, g, params, n_heads)
        LAUNCHES["fused_attention_pair_vjp_bwd"] += 1
    return (dx.reshape(x.shape), dcond.reshape(cond.shape),
            *(gr.reshape(p.shape) for gr, p in zip(grads, params)))


class FusedAttnPairFunction(torch.autograd.Function):
    """The attention pair as an autograd function over the kernels (their
    plain versions on CPU tensors). The forward saves only its inputs, as
    the TPU kernel's `_vjp_fwd` does; the backward recomputes. All nine
    gradients come back, each in its input's dtype."""

    @staticmethod
    def forward(ctx, x, cond, ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv,
                n_heads: int):
        ctx.save_for_backward(x, cond, ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv)
        ctx.n_heads = n_heads
        return fused_attention_pair_fwd(x, cond, ln1s, ln1b, wqkv, ln2s, ln2b,
                                        wq, wkv, n_heads)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        grads = fused_attention_pair_bwd(inputs[0], inputs[1], g.contiguous(),
                                         *inputs[2:], ctx.n_heads)
        return (*(gr.to(t.dtype) for gr, t in zip(grads, inputs)), None)


def fused_attention_pair_vjp(x, cond, ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv,
                             n_heads: int):
    """x2 = (x + SA(LN1 x)) + CA(LN2(x + SA(LN1 x)), cond), differentiable
    with respect to all nine tensors (the JAX package's
    `fused_attention_pair_vjp`). x (B, N, D) with N <= 256 and cond
    (B, 2, D) in the weights' dtype; wqkv (3D, D), wq (D, D), wkv (2D, D);
    LayerNorm scales and shifts (D,) float32."""
    return FusedAttnPairFunction.apply(
        x, cond, *(t.contiguous() for t in (ln1s, ln1b, wqkv, ln2s, ln2b, wq,
                                            wkv)), n_heads)
