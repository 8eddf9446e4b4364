"""The differentiable decoder layer of the training step (TPU kernel K2).

Counterpart of the JAX package's `ops/fused_layer_vjp.py`, whose two
Pallas kernels run one whole decoder layer per batch element:

    x1 = x + SelfAttn(LN1 x)
    x2 = x1 + CrossAttn(LN2 x1, cond)
    x3 = x2 + Contract(GELU(DW3x3(Expand(LN3 x2))))

forward in one kernel, and backward in one kernel that recomputes the
forward internals in VMEM and returns dx, dcond and all 15 parameter
gradients, accumulating the weight gradients across its sequential batch
grid. A Hopper SM has 227 KB of shared memory and its blocks run in no
order, so here:

- the forward is K1's four kernels (`ops/fused_stack.py`) with K2's own
  rounding points: the expanded hidden state h and the depthwise output c
  stay float32 (`ln_gemm` with `out_dtype=float32`, `dwconv_gelu` on
  float32 input), only the GELU output is rounded before the contract
  product;
- the backward recomputes the forward with the same kernels, keeping only
  what it reads (the bf16 rows xn1, xn2, xn3, qkv, qc, kv, a and the
  float32 x1, x2, h, c; one layer's at a time, as the TPU kernel's
  recompute), and then runs in reverse through the kernels of `csrc/`:
  `weight_grad` (dW = dY^T X, split over M with deterministic partial
  sums inside the kernel), `colsum` (the bias and LayerNorm sums),
  `layernorm_bwd`, `dwconv_gelu_bwd`, `self_attention_bwd` and
  `cross_attention_bwd`; the input-gradient products dX = dY W run in
  `ln_gemm`'s streaming mode with W read as stored (`w_transposed`).

Each kernel has a plain PyTorch version here (`*_plain`), and a wrapper
that runs the plain version for CPU tensors and otherwise checks its
inputs, launches the kernel, raises if the launch failed and counts it in
`LAUNCHES`. With float32 weights (`TrainConfig(compute_dtype="float32")`:
the TPU kernel's `mxu` is the weights' dtype, so nothing is rounded) the
same composition runs the float32 bodies: K1's of `ops/fused_stack_f32.py`
for the recompute and the dX products, and `ops/fused_layer_vjp_f32.py`'s
for the rest, to which the wrappers below send float32 operands. `fused_layer_fwd_plain` / `fused_layer_bwd_plain` write the
whole layer's math out in one piece (the TPU kernel's `_fwd_kernel` and
`_bwd_kernel`); `FusedLayerFunction` is the autograd function over the
kernel path.

The probe scripts/probe_train_bwd_stage.py (S2, `pallas_bwd_variant`)
ablates the backward: `fused_layer_bwd_variant(mode, ...)` runs it in the
modes `BWD_MODES` over the same kernels, and `fused_layer_bwd_variant_plain`
is its plain version ("full" is `fused_layer_bwd` and
`fused_layer_bwd_plain` themselves). The port has no dead-code elimination
to defeat, so an ablated section is simply not run; the outputs it would
write come back as None. "bf16res" keeps the recompute's residuals in
bf16: the input rows x (as given), x1 and x2 (whose LayerNorm statistics
and xhat `layernorm_bwd` recomputes from the rounded rows), h and c
(`dwconv_gelu_bwd` reads them as bf16). The attention probabilities are
recomputed in registers by the backward kernels, never stored, so they
stay float32 (the TPU variant rounds them too).

Rounding points are the TPU kernel's (`_bwd_kernel:175-243`): the upstream
gradient g, dhid, the attention's output-gradient head slices, ds, dqc,
dkv and dqkv are rounded to the weights' dtype before each product, and so
are a, the xn rows, p and cond as product operands; every sum is float32.
Parameters use the port's (reference torch) layouts: projections (out,
in), depthwise taps (9, hidden) with tap di*3+dj, LayerNorm scales and
shifts and biases as vectors.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.ops._build import load_library
from transformer_latent_diffusion_tpu_torch.ops.fused_stack import (
    _check_launch,
    _on_cuda,
    _ptr,
    _require,
    _stream,
)

LN_EPS = 1e-5

PARAM_NAMES = ("ln1s", "ln1b", "wqkv", "ln2s", "ln2b", "wq", "wkv",
               "ln3s", "ln3b", "w1", "b1", "dw", "dwb", "w2", "b2")

KERNELS = ("weight_grad", "colsum", "layernorm_bwd", "dwconv_gelu_bwd",
           "self_attention_bwd", "cross_attention_bwd")
# the backward's modes of scripts/probe_train_bwd_stage.py (S2): the whole
# backward, its residuals in bf16, the recompute alone, and the backward
# without its MLP, cross-attention or self-attention section
BWD_MODES = ("full", "bf16res", "recompute", "no_mlp", "no_cross", "no_self")
# kernel launches since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

# colsum's columns per block (csrc/gemm_bwd.cu), and the blocks a call aims
# at: one wave of three 256-thread blocks on each of an H100's 132 SMs
COLSUM_COLS = 128
COLSUM_BLOCKS = 384


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# ------------------------- the TPU kernel's helpers -------------------------


def _ln_fwd(x, scale, bias):
    m = x.mean(-1, keepdim=True)
    var = (x - m).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xhat = (x - m) * rstd
    return xhat * scale + bias, xhat, rstd


def _ln_bwd(dy, xhat, rstd, scale):
    """(dx, dscale, dbias) of a LayerNorm over the last axis; the sums run
    over every other axis."""
    rows = tuple(range(dy.ndim - 1))
    dscale = (dy * xhat).sum(rows)
    dbias = dy.sum(rows)
    dxhat = dy * scale
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx, dscale, dbias


def _softmax_rows(s):
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _softmax_bwd(p, dp):
    return p * (dp - (dp * p).sum(-1, keepdim=True))


def _gelu_f32(c):
    return 0.5 * c * (1.0 + torch.erf(c * (1.0 / math.sqrt(2.0))))


def _gelu_grad_f32(c):
    cdf = 0.5 * (1.0 + torch.erf(c * (1.0 / math.sqrt(2.0))))
    pdf = torch.exp(-0.5 * c * c) * (1.0 / math.sqrt(2.0 * math.pi))
    return cdf + c * pdf


def _dw_fwd(grid, w, hw: int, flip: bool = False):
    """3x3 depthwise correlation (zero padding) of (B, hw, hw, K) with taps
    w (9, K), in the TPU kernel's order; flip=True uses the reversed taps
    (the input gradient)."""
    def tap(di, dj):
        idx = di * 3 + dj
        return w[8 - idx] if flip else w[idx]

    pr = F.pad(grid, (0, 0, 0, 0, 1, 1))
    zs = [pr[:, 0:hw] * tap(0, dj) + pr[:, 1:hw + 1] * tap(1, dj)
          + pr[:, 2:hw + 2] * tap(2, dj) for dj in range(3)]
    return (F.pad(zs[0], (0, 0, 1, 1))[:, :, 0:hw] + zs[1]
            + F.pad(zs[2], (0, 0, 1, 1))[:, :, 2:hw + 2])


def _dw_input_grad(dc, w, hw: int):
    return _dw_fwd(dc, w, hw, flip=True)


def _dw_tap_grads(h, dc, hw: int):
    """(9, K): sum over images and pixels of h[p + (di-1, dj-1)] dc[p]."""
    pr = F.pad(h, (0, 0, 0, 0, 1, 1))
    pd = F.pad(dc, (0, 0, 1, 1))
    dcs = [pd[:, :, 2:hw + 2], dc, pd[:, :, 0:hw]]
    return torch.stack([(pr[:, di:di + hw] * dcs[dj]).sum((0, 1, 2))
                        for di in range(3) for dj in range(3)])


def _heads(t, n_heads):
    """(B, N, D) -> (B, H, N, dh)."""
    b, n, d = t.shape
    return t.reshape(b, n, n_heads, d // n_heads).transpose(1, 2)


def _merge(t):
    """(B, H, N, dh) -> (B, N, D)."""
    b, h, n, dh = t.shape
    return t.transpose(1, 2).reshape(b, n, h * dh)


def _mm(a, b, lp):
    """a @ b of `lp`-rounded operands, float32 accumulation."""
    return a.to(lp).float() @ b.to(lp).float()


# ------------------------------ the layer, plain ------------------------------


def _attn_pair_residuals(x, cond, attn_params, n_heads: int):
    """The attention pair's forward, plain (the first seven parameters of
    PARAM_NAMES): everything its backward reads, x2 included."""
    ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv = attn_params
    lp = wqkv.dtype
    d = x.shape[-1]
    scale = 1.0 / math.sqrt(d // n_heads)
    x = x.float()
    cond = cond.float()
    xn1, xhat1, rstd1 = _ln_fwd(x, ln1s.float(), ln1b.float())
    qkv = _mm(xn1, wqkv.T, lp).to(lp)
    q, k, v = (_heads(t, n_heads) for t in qkv.split(d, -1))
    p_self = _softmax_rows(_mm(q, k.transpose(-1, -2), lp) * scale)
    x1 = x + _merge(_mm(p_self, v, lp))
    xn2, xhat2, rstd2 = _ln_fwd(x1, ln2s.float(), ln2b.float())
    qc = _mm(xn2, wq.T, lp).to(lp)
    kv = _mm(cond, wkv.T, lp).to(lp)
    kc, vc = (_heads(t, n_heads) for t in kv.split(d, -1))
    qch = _heads(qc, n_heads)
    p_cross = _softmax_rows(_mm(qch, kc.transpose(-1, -2), lp) * scale)
    x2 = x1 + _merge(_mm(p_cross, vc, lp))
    return dict(x=x, cond=cond, lp=lp, scale=scale, xn1=xn1, xhat1=xhat1,
                rstd1=rstd1, q=q, k=k, v=v, p_self=p_self, x1=x1, xn2=xn2,
                xhat2=xhat2, rstd2=rstd2, qc=qch, kc=kc, vc=vc,
                p_cross=p_cross, x2=x2)


def _forward_residuals(x, cond, params, n_heads: int, hw: int,
                       bf16res: bool = False):
    """Everything the backward reads. bf16res: as the kernel path keeps
    them in that mode, h is rounded to the weights' dtype before the
    depthwise convolution, c after it (the GELU output a is taken from the
    unrounded c), and the LayerNorms' xhat and rstd are recomputed from
    the rounded rows x, x1 and x2."""
    r = _attn_pair_residuals(x, cond, params[:7], n_heads)
    ln3s, ln3b, w1, b1, dw, dwb = params[7:13]
    lp = r["lp"]
    xn3, xhat3, rstd3 = _ln_fwd(r["x2"], ln3s.float(), ln3b.float())
    b = x.shape[0]
    h = _mm(xn3, w1.T, lp) + b1.float()
    if bf16res:
        h = h.to(lp).float()
    c = _dw_fwd(h.reshape(b, hw, hw, -1), dw.float(), hw) + dwb.float()
    a = _gelu_f32(c).reshape(h.shape)
    r.update(xn3=xn3, xhat3=xhat3, rstd3=rstd3, h=h, c=c, a=a)
    if bf16res:
        r["c"] = c.to(lp).float()
        for i, key in ((1, "x"), (2, "x1"), (3, "x2")):
            _, r[f"xhat{i}"], r[f"rstd{i}"] = _ln_fwd(r[key].to(lp).float(), 1.0, 0.0)
    return r


def fused_layer_fwd_plain(x, cond, params: Sequence[torch.Tensor],
                          n_heads: int, hw: int):
    """The TPU kernel's `_fwd_kernel`, written out: x (B, N, D), cond
    (B, 2, D); the result in x's dtype."""
    r = _forward_residuals(x, cond, params, n_heads, hw)
    w2, b2 = params[13], params[14]
    y = _mm(r["a"], w2.T, r["lp"]) + b2.float()
    return (r["x2"] + y).to(x.dtype)


def _attention_bwd_plain(p, q, k, v, dout, scale, lp):
    """dq, dk, dv of softmax attention per head from the recomputed p;
    dout (B, H, Nq, dh) float32."""
    gh = dout.to(lp)
    dv = _mm(p.transpose(-1, -2), gh, lp)
    dp = _mm(gh, v.transpose(-1, -2), lp)
    ds = (_softmax_bwd(p, dp) * scale).to(lp)
    return _mm(ds, k, lp), _mm(ds.transpose(-1, -2), q, lp), dv


def _tn(a, b, lp):
    """a^T b over all rows of lp-rounded operands: (out, in) weight
    gradients."""
    return _mm(a.reshape(-1, a.shape[-1]).T, b.reshape(-1, b.shape[-1]), lp)


def _attn_pair_bwd_plain(r, dx2, attn_params, n_heads: int, cross: bool = True,
                         self_attn: bool = True):
    """The attention pair's backward, plain, from the float32 gradient dx2
    at its output x2 and its residuals `r` (`_attn_pair_residuals`): (dx,
    dcond, the seven parameter gradients), all float32. cross=False or
    self_attn=False skips that attention's section (S2's "no_cross" and
    "no_self"): the gradient passes through it unchanged, and what it
    would compute comes back as None."""
    ln1s, _, wqkv, ln2s, _, wq, wkv = attn_params
    lp, scale = r["lp"], r["scale"]
    dx1, dcond, ds2, db2, dwq, dwkv = dx2, None, None, None, None, None
    if cross:
        dqc, dkc, dvc = _attention_bwd_plain(r["p_cross"], r["qc"], r["kc"],
                                             r["vc"], _heads(dx2, n_heads),
                                             scale, lp)
        dqc_lp = _merge(dqc).to(lp)
        dkv_lp = torch.cat([_merge(dkc), _merge(dvc)], -1).to(lp)
        dwq = _tn(dqc_lp, r["xn2"], lp)
        dxn2 = _mm(dqc_lp, wq, lp)
        dwkv = _tn(dkv_lp, r["cond"], lp)
        dcond = _mm(dkv_lp, wkv, lp)
        dx1_ln, ds2, db2 = _ln_bwd(dxn2, r["xhat2"], r["rstd2"], ln2s.float())
        dx1 = dx2 + dx1_ln

    dx, ds1, db1, dwqkv = dx1, None, None, None
    if self_attn:
        dq, dk, dv = _attention_bwd_plain(r["p_self"], r["q"], r["k"], r["v"],
                                          _heads(dx1, n_heads), scale, lp)
        dqkv_lp = torch.cat([_merge(dq), _merge(dk), _merge(dv)], -1).to(lp)
        dwqkv = _tn(dqkv_lp, r["xn1"], lp)
        dxn1 = _mm(dqkv_lp, wqkv, lp)
        dx_ln, ds1, db1 = _ln_bwd(dxn1, r["xhat1"], r["rstd1"], ln1s.float())
        dx = dx1 + dx_ln
    return dx, dcond, [ds1, db1, dwqkv, ds2, db2, dwq, dwkv]


def _bwd_outputs(dx, dcond, grads, x, cond, params):
    """(dx in x's dtype, dcond in cond's dtype, the parameter gradients
    shaped like the parameters); an output a mode skips stays None."""
    return (dx.reshape(x.shape).to(x.dtype),
            None if dcond is None else dcond.reshape(cond.shape).to(cond.dtype),
            [None if gr is None else gr.reshape(p.shape)
             for gr, p in zip(grads, params)])


def fused_layer_bwd_variant_plain(mode: str, x, cond, g,
                                  params: Sequence[torch.Tensor], n_heads: int,
                                  hw: int):
    """The TPU kernel's `_bwd_kernel` (mode "full"), and S2's ablations of
    it (`BWD_MODES`, scripts/probe_train_bwd_stage.py's `make_bwd_kernel`),
    written out: (dx, dcond, the 15 parameter gradients in float32), with
    None for what a mode does not compute. "recompute" returns the
    recomputed x2 as dx; "no_mlp" starts the attention pair's backward
    from dx2 = g; "no_cross" and "no_self" pass the gradient through that
    attention; "bf16res" reads the residuals as `_forward_residuals`
    rounds them."""
    _require(mode in BWD_MODES, f"fused_layer_bwd: mode is one of {BWD_MODES}")
    r = _forward_residuals(x, cond, params, n_heads, hw, mode == "bf16res")
    if mode == "recompute":
        return _bwd_outputs(r["x2"], None, [None] * len(params), x, cond, params)
    ln3s, _, w1, _, dw, _, w2, _ = params[7:]
    lp = r["lp"]
    b, n, d = x.shape
    rows = (0, 1)
    g = g.float()
    dx2, mlp_grads = g, [None] * 8
    if mode != "no_mlp":
        g_lp = g.to(lp)
        dw2 = _tn(g_lp, r["a"], lp)
        db2 = g.sum(rows)
        da = _mm(g_lp, w2, lp)
        dc = da.reshape(b, hw, hw, -1) * _gelu_grad_f32(r["c"])
        ddwb = dc.sum((0, 1, 2))
        ddw = _dw_tap_grads(r["h"].reshape(b, hw, hw, -1), dc, hw)
        dhid = _dw_input_grad(dc, dw.float(), hw).reshape(b, n, -1)
        dhid_lp = dhid.to(lp)
        dw1 = _tn(dhid_lp, r["xn3"], lp)
        db1 = dhid.sum(rows)
        dxn3 = _mm(dhid_lp, w1, lp)
        dx2_ln, ds3, db3 = _ln_bwd(dxn3, r["xhat3"], r["rstd3"], ln3s.float())
        dx2 = g + dx2_ln
        mlp_grads = [ds3, db3, dw1, db1, ddw, ddwb, dw2, db2]
    dx, dcond, attn_grads = _attn_pair_bwd_plain(
        r, dx2, params[:7], n_heads, cross=mode != "no_cross",
        self_attn=mode != "no_self")
    return _bwd_outputs(dx, dcond, attn_grads + mlp_grads, x, cond, params)


def fused_layer_bwd_plain(x, cond, g, params: Sequence[torch.Tensor],
                          n_heads: int, hw: int):
    """The TPU kernel's `_bwd_kernel`, written out: (dx in x's dtype, dcond
    in cond's dtype, the 15 parameter gradients in float32, shaped like
    the parameters)."""
    return fused_layer_bwd_variant_plain("full", x, cond, g, params, n_heads, hw)


# ------------------------------ kernel plain versions ------------------------------


def weight_grad_plain(dy, x):
    """dY^T X in float32 from operands as given: dy (M, N), x (M, K) ->
    (N, K)."""
    return dy.float().T @ x.float()


def colsum_plain(x):
    """Column sums of a float32 or bf16 (R, C) matrix -> (C,), float32."""
    return x.float().sum(0)


def layernorm_bwd_plain(dy, x, scale, upstream):
    """(upstream + the LayerNorm backward of dy, dscale, dbias): x is the
    LayerNorm's float32 input (its statistics are recomputed, eps 1e-5);
    dy, upstream (M, D) float32; scale (D,)."""
    _, xhat, rstd = _ln_fwd(x.float(), 1.0, 0.0)
    dx, dscale, dbias = _ln_bwd(dy.float(), xhat, rstd, scale.reshape(-1))
    return upstream + dx, dscale, dbias


def dwconv_gelu_bwd_plain(da, c, h, dw, hw: int):
    """Backward of GELU(3x3 depthwise(h) + dwb) on the hw x hw grid:
    (dhid rounded to dw.dtype, the (9, C) tap gradients, ddwb, db1), all
    sums float32 over the (B*hw*hw, C) rows."""
    m, ch = da.shape
    b = m // (hw * hw)
    dc = (da.float() * _gelu_grad_f32(c.float())).reshape(b, hw, hw, ch)
    dhid = _dw_input_grad(dc, dw.float(), hw).reshape(m, ch)
    taps = _dw_tap_grads(h.float().reshape(b, hw, hw, ch), dc, hw)
    return dhid.to(dw.dtype), taps, dc.sum((0, 1, 2)), dhid.sum(0)


def self_attention_bwd_plain(qkv, dout, n_heads: int, n_tokens: int):
    """(B*N, 3D) rows [dq | dk | dv] in qkv's dtype, from the forward's qkv
    rows and the float32 gradient of the attention output (B*N, D)."""
    m, three_d = qkv.shape
    d = three_d // 3
    b = m // n_tokens
    lp = qkv.dtype
    q, k, v = (_heads(t.reshape(b, n_tokens, d), n_heads)
               for t in qkv.split(d, -1))
    scale = 1.0 / math.sqrt(d // n_heads)
    p = _softmax_rows(_mm(q, k.transpose(-1, -2), lp) * scale)
    grads = _attention_bwd_plain(p, q, k, v,
                                 _heads(dout.reshape(b, n_tokens, d), n_heads),
                                 scale, lp)
    return torch.cat([_merge(t) for t in grads], -1).reshape(m, three_d).to(lp)


def cross_attention_bwd_plain(qc, kv, dout, n_heads: int, n_tokens: int):
    """(dqc (B*N, D), dkv (B*2, 2D) in kv's row layout), both in qc's
    dtype, of the 2-key cross-attention."""
    m, d = qc.shape
    b = m // n_tokens
    lp = qc.dtype
    q = _heads(qc.reshape(b, n_tokens, d), n_heads)
    k, v = (_heads(t.reshape(b, 2, d), n_heads) for t in kv.split(d, -1))
    scale = 1.0 / math.sqrt(d // n_heads)
    p = _softmax_rows(_mm(q, k.transpose(-1, -2), lp) * scale)
    dq, dk, dv = _attention_bwd_plain(
        p, q, k, v, _heads(dout.reshape(b, n_tokens, d), n_heads), scale, lp)
    dkv = torch.cat([_merge(dk), _merge(dv)], -1).reshape(2 * b, 2 * d)
    return _merge(dq).reshape(m, d).to(lp), dkv.to(lp)


# ------------------------------ kernel wrappers ------------------------------


def _count(name: str) -> None:
    LAUNCHES[name] += 1


def _f32():
    """The float32 bodies of the backward and their launch counts
    (`ops/fused_layer_vjp_f32.py`, which imports this module)."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp_f32

    return fused_layer_vjp_f32


def colsum_slice_rows(r: int, c: int) -> int:
    """The rows of an (r, c) x that one `colsum` block sums: about
    COLSUM_BLOCKS blocks in all, slices of at least 64 rows, a multiple of
    the kernel's 8 row lanes. It depends on the shape alone, so the order
    of the sums does too."""
    slices = max(1, min(-(-r // 64), COLSUM_BLOCKS // -(-c // COLSUM_COLS)))
    return -(-(-(-r // slices)) // 8) * 8


# zeroed int32 counters of the kernels that count their blocks in (colsum,
# dwconv_gelu_bwd): one buffer per device and stream, which those kernels
# leave at zero again (work on one stream runs in order)
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _zeroed_counters(dev: torch.device, n: int) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
    return buf


def colsum(x):
    """Kernel wrapper of `colsum_plain`: one launch at any R, deterministic
    (the slices' sums are added in a fixed order inside the kernel); x
    float32, or bf16 (read as it is, widened in the kernel)."""
    if x.device.type == "cpu":
        return colsum_plain(x)
    dev = _on_cuda("colsum", x)
    _require(x.dtype in (torch.float32, torch.bfloat16) and x.ndim == 2 and x.numel() > 0,
             "colsum: x must be a non-empty float32 or bf16 (R, C) matrix")
    r, c = x.shape
    rows = colsum_slice_rows(r, c)
    # the sums, then the slices' sums (at most COLSUM_BLOCKS rows of c), in
    # one allocation
    buf = torch.empty((1 + -(-r // rows)) * c, dtype=torch.float32, device=dev)
    out, ws = buf[:c], buf[c:]
    counters = _zeroed_counters(dev, -(-c // COLSUM_COLS))
    lib = load_library()
    _count("colsum")
    _check_launch(lib.ltd_colsum(_ptr(x), _ptr(out), _ptr(ws), _ptr(counters), r, c,
                                 rows, int(x.dtype == torch.bfloat16), _stream(dev)),
                  "colsum")
    return out


# weight_grad's output tile (rows n, columns k) and the rows of M per stage;
# the float32 body's (csrc/gemm_bwd_f32.cu)
WG_TILE = (128, 256)
WG_STAGE_ROWS = 64
WG_TILE_F32 = (128, 128)
WG_STAGE_ROWS_F32 = 32
# ints per record of a plan's table (csrc/gemm_bwd.cu)
WG_RECORD = 8
# below this many stages per SM, weight_grad runs whole tiles
WG_MIN_STAGES = 16


@dataclass(frozen=True)
class WeightGradPlan:
    """How `weight_grad`'s persistent grid covers dW = dY^T X.

    The output is cut into `tiles` tiles of WG_TILE (`tile_cols` per
    row of tiles; the last row and column of tiles ragged where N or K is
    not a multiple of the tile, masked by the kernel), the M rows into
    `depth` stages of WG_STAGE_ROWS, the last one masked by the tensor
    map where M is ragged, and each tile's
    stages into `splits` contiguous M-splits. `segments[p]` are the pieces
    that block p of `blocks` runs, in order, each a record (tile row, tile
    column, first stage, stages, first slab of the tile or -1, index among
    the tile's segments, the tile's segments, tile): a tile of several
    segments sums their float32 partials, `slabs` of them in all, in
    segment (M) order."""
    tile_cols: int
    tiles: int
    depth: int
    splits: int
    blocks: int
    segments: Tuple[Tuple[Tuple[int, ...], ...], ...]
    slabs: int

    def table(self) -> List[int]:
        """The int32 table the kernel reads: blocks + 1 offsets into the
        records, then the records."""
        offsets, recs = [0], []
        for block in self.segments:
            offsets.append(offsets[-1] + len(block))
            for rec in block:
                recs.extend(rec)
        return offsets + recs


@functools.lru_cache(maxsize=64)
def weight_grad_plan(m: int, n: int, k: int, sms: int, tile: Tuple[int, int] = WG_TILE,
                     stage_rows: int = WG_STAGE_ROWS) -> WeightGradPlan:
    """The work plan of `weight_grad` for dY (m, n) and X (m, k) on `sms`
    SMs (pure: no device is touched), in output tiles of `tile` and stages
    of `stage_rows` rows of M (the float32 body's: WG_TILE_F32,
    WG_STAGE_ROWS_F32).

    With fewer than WG_MIN_STAGES stages per SM (the cond rows' M = 16 or
    256) a split tile's float32 partials would cost more than they save:
    whole tiles are dealt round-robin, one block per tile up to one per
    SM, so the blocks' stages differ by at most one tile's depth. Beyond,
    the stages are dealt stream-K fashion: every SM gets the same number
    of 64-row stages to within one (no tail wave). The tiles are then cut
    into at most two M-splits (more were slower on an H100: more
    segments, more partials), and each SM runs its pieces in the order of
    their offset in their split, so that the SMs running at once read the
    same rows of dY and X from L2."""
    if m < 1 or n < 8 or k < 8 or n % 8 or k % 8 or sms < 1:
        raise ValueError(f"weight_grad_plan: needs M >= 1, N % 8 == 0 and K % 8 "
                         f"== 0, got {m}, {n}, {k} on {sms} SMs")
    tile_cols = -(-k // tile[1])
    tiles = -(-n // tile[0]) * tile_cols
    depth = -(-m // stage_rows)
    total = tiles * depth
    # (tile, first stage, stages, offset in its split) per block
    if total < WG_MIN_STAGES * sms:
        splits, blocks = 1, min(sms, tiles)
        pieces = [[(t, 0, depth, 0) for t in range(p, tiles, blocks)] for p in range(blocks)]
    else:
        splits, blocks = min(2, depth, -(-sms // tiles)), sms
        bounds = [j * depth // splits for j in range(splits + 1)]
        cuts = [p * total // blocks for p in range(blocks + 1)]
        pieces = [[] for _ in range(blocks)]
        pos, p = 0, 0
        for j in range(splits):
            for t in range(tiles):
                lo, hi = bounds[j], bounds[j + 1]
                while lo < hi:
                    while cuts[p + 1] <= pos:
                        p += 1
                    take = min(hi - lo, cuts[p + 1] - pos)
                    pieces[p].append((t, lo, take, lo - bounds[j]))
                    lo += take
                    pos += take
    by_tile: Dict[int, List[int]] = {}
    for block in pieces:
        for t, lo, _, _ in block:
            by_tile.setdefault(t, []).append(lo)
    slab0, slabs = {}, 0
    for t in range(tiles):
        by_tile[t].sort()
        if len(by_tile[t]) > 1:
            slab0[t] = slabs
            slabs += len(by_tile[t])
    segments = tuple(
        tuple((t // tile_cols, t % tile_cols, lo, cnt, slab0.get(t, -1),
               by_tile[t].index(lo), len(by_tile[t]), t)
              for t, lo, cnt, _ in sorted(block, key=lambda piece: piece[3]))
        for block in pieces)
    return WeightGradPlan(tile_cols, tiles, depth, splits, blocks, segments, slabs)


@functools.lru_cache(maxsize=64)
def _plan_on(m: int, n: int, k: int, dev: torch.device, tile: Tuple[int, int] = WG_TILE,
             stage_rows: int = WG_STAGE_ROWS):
    """`weight_grad_plan` for `dev`'s SMs, and its int32 table on `dev`
    (copied there once per shape)."""
    plan = weight_grad_plan(m, n, k, torch.cuda.get_device_properties(dev).multi_processor_count,
                            tile, stage_rows)
    return plan, torch.tensor(plan.table(), dtype=torch.int32, device=dev)


def weight_grad(dy, x):
    """Kernel wrapper of `weight_grad_plain`; on CUDA dy and x are
    contiguous bf16 with N % 8 == 0 and K % 8 == 0 (ragged last tiles are
    masked), any M. One launch:
    the partial sums of a tile cut over several SMs are combined by the
    kernel itself, in a fixed order (`weight_grad_plan`). Float32 dy
    takes the float32 body (`fused_layer_vjp_f32.weight_grad_f32`)."""
    if dy.device.type == "cpu":
        return weight_grad_plain(dy, x)
    if dy.dtype == torch.float32:
        return _f32().weight_grad_f32(dy, x)
    dev = _on_cuda("weight_grad", dy, x)
    m, n = dy.shape
    k = x.shape[1]
    _require(dy.dtype == torch.bfloat16 and x.dtype == torch.bfloat16
             and x.shape[0] == m and m > 0,
             "weight_grad: dy (M, N) and x (M, K) bf16")
    _require(n % 8 == 0 and k % 8 == 0,
             f"weight_grad: needs N % 8 == 0 and K % 8 == 0, got {n}, {k}")
    _require(fs.tma_operand(dy) and fs.tma_operand(x),
             "weight_grad: dy and x must be contiguous and 16-byte aligned")
    plan, table = _plan_on(m, n, k, dev)
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    ws = torch.empty((max(plan.slabs, 1), WG_TILE[0] * WG_TILE[1]),
                     dtype=torch.float32, device=dev)
    counters = torch.zeros(plan.tiles, dtype=torch.int32, device=dev)
    lib = load_library()
    _count("weight_grad")
    _check_launch(lib.ltd_weight_grad(_ptr(dy), _ptr(x), _ptr(out), _ptr(ws),
                                      _ptr(counters), _ptr(table), m, n, k,
                                      plan.blocks, _stream(dev)),
                  "weight_grad")
    return out


# the widest row layernorm_bwd's warp holds in registers (csrc/layernorm_bwd.cu)
LN_BWD_MAX_D = 1024


def layernorm_bwd(dy, x, scale, upstream):
    """Kernel wrapper of `layernorm_bwd_plain`; on CUDA x float32 or bf16
    (the "bf16res" residuals), the rest float32, D a multiple of 4 and at
    most LN_BWD_MAX_D."""
    if dy.device.type == "cpu":
        return layernorm_bwd_plain(dy, x, scale, upstream)
    dev = _on_cuda("layernorm_bwd", dy, x, scale, upstream)
    m, d = dy.shape
    _require(all(t.dtype == torch.float32 for t in (dy, scale, upstream))
             and x.dtype in (torch.float32, torch.bfloat16)
             and x.shape == (m, d) and upstream.shape == (m, d)
             and scale.numel() == d and d % 4 == 0 and d <= LN_BWD_MAX_D,
             "layernorm_bwd: float32 dy, upstream (M, D) and scale (D,), x "
             f"(M, D) float32 or bf16, D % 4 == 0 and D <= {LN_BWD_MAX_D}")
    dx = torch.empty_like(dy)
    partial = torch.empty(((m + 31) // 32, 2 * d), dtype=torch.float32,
                          device=dev)
    lib = load_library()
    _count("layernorm_bwd")
    _check_launch(lib.ltd_layernorm_bwd(_ptr(dy), _ptr(x), _ptr(scale),
                                        _ptr(upstream), _ptr(dx), _ptr(partial),
                                        m, d, int(x.dtype == torch.bfloat16),
                                        _stream(dev)), "layernorm_bwd")
    sums = colsum(partial)
    return dx, sums[:d], sums[d:]


# dwconv_gelu_bwd's channels per unit, the most grid rows of a band, the
# stages of its ring and the bytes of its walk group's sum exchange (8 warps
# x 11 sums x 32 channels; csrc/dwconv_gelu_bwd.cu)
DWB_CHUNK = 32
DWB_BAND_ROWS = 8
DWB_STAGES = 2
DWB_RED_BYTES = 8 * 11 * DWB_CHUNK * 4


def dwconv_gelu_bwd_smem(band: int, hw: int, item: int) -> int:
    """The shared memory of a `dwconv_gelu_bwd` block whose units hold
    `band` rows of an hw-wide grid, c and h of `item` bytes an element
    (`smem_bytes` of csrc/dwconv_gelu_bwd.cu): the alignment slack, the
    ring's stages (the dc (float32) and h slabs, or the sum exchange where
    that is larger), one buffer of c, 5 barriers and a flag, each slab
    (band + 2) x (hw + 2) x 32 rounded up to 128 bytes."""
    box = (band + 2) * (hw + 2) * DWB_CHUNK

    def slab(n):
        return -(-n // 128) * 128

    stage = max(slab(box * 4) + slab(box * item), DWB_RED_BYTES)
    return 128 + DWB_STAGES * stage + slab(box * item) + 48


def dwconv_gelu_bwd_body(hw: int, dtype=torch.float32) -> int:
    """How `dwconv_gelu_bwd` cuts an hw x hw grid whose c and h are of
    `dtype`: 0 for the whole grid as one unit, where its slabs fit a
    block's shared memory (float32 up to hw = 17, bf16 up to 20), else the
    grid rows of a band, the most up to DWB_BAND_ROWS that fit (8 at hw =
    32; float32 down to 1 row at hw = 118, bf16 at 170). Raises ValueError
    beyond."""
    item = torch.finfo(dtype).bits // 8
    if dwconv_gelu_bwd_smem(hw, hw, item) <= fs.SMEM_PER_BLOCK:
        return 0
    for rows in range(min(DWB_BAND_ROWS, hw), 0, -1):
        if dwconv_gelu_bwd_smem(rows, hw, item) <= fs.SMEM_PER_BLOCK:
            return rows
    raise ValueError(f"dwconv_gelu_bwd: one row of a {hw} x {hw} grid of {dtype} exceeds "
                     f"the {fs.SMEM_PER_BLOCK}-byte shared memory of a block")


@dataclass(frozen=True)
class DwconvGeluBwdPlan:
    """How `dwconv_gelu_bwd`'s persistent grid covers `images` hw x hw grids
    of `channels` channels, as csrc/dwconv_gelu_bwd.cu walks them.

    A unit is (image, band of `band` grid rows, chunk of DWB_CHUNK
    channels), numbered u = (image * bands + band) * chunks + chunk (the
    whole grid is one band of hw rows); block p of a grid of g blocks walks
    units p, p + g, ... (`walk`). Each unit writes its 11 x 32 partial sums
    to workspace row image * bands + band; the unit that arrives last of
    its chunk adds the chunk's `rows` rows, each of `sum_runs` in row order
    (image-major, bands in order within an image), then the second run's
    total to the first's. No part of this depends on the grid."""
    images: int
    hw: int
    channels: int
    band: int
    bands: int
    chunks: int

    @property
    def rows(self) -> int:
        """The partial rows of a chunk."""
        return self.images * self.bands

    @property
    def units(self) -> int:
        return self.rows * self.chunks

    def unit(self, u: int) -> Tuple[int, int, int]:
        """(image, band, chunk) of unit u."""
        row, chunk = divmod(u, self.chunks)
        return row // self.bands, row % self.bands, chunk

    def walk(self, block: int, grid: int) -> range:
        """The units block `block` of `grid` takes, in order."""
        return range(block, self.units, grid)

    def sum_runs(self) -> Tuple[range, range]:
        """The two runs of partial rows that the last unit of a chunk sums."""
        half = -(-self.rows // 2)
        return range(half), range(half, self.rows)


def dwconv_gelu_bwd_plan(images: int, hw: int, channels: int,
                         dtype=torch.float32) -> DwconvGeluBwdPlan:
    """The plan of `dwconv_gelu_bwd` for `images` grids (pure: no device is
    touched); c and h of `dtype`."""
    if channels % DWB_CHUNK or images < 1 or hw < 1:
        raise ValueError(f"dwconv_gelu_bwd_plan: needs C % {DWB_CHUNK} == 0 and a "
                         f"grid, got {images} x {hw} x {hw} x {channels}")
    band = dwconv_gelu_bwd_body(hw, dtype) or hw
    return DwconvGeluBwdPlan(images, hw, channels, band, -(-hw // band),
                             channels // DWB_CHUNK)


def dwconv_gelu_bwd(da, c, h, dw, hw: int):
    """Kernel wrapper of `dwconv_gelu_bwd_plain`; on CUDA da float32, c and
    h both float32 or both bf16 (the "bf16res" residuals), dw (9, C),
    C % 32 == 0 and a grid that `dwconv_gelu_bwd_body` cuts. One launch:
    the kernel sums its units' partials itself. bf16 taps give a bf16
    dhid; float32 taps (float32 c and h) the float32 mode, a float32 dhid,
    counted as "dwconv_gelu_bwd_f32" in `fused_layer_vjp_f32.LAUNCHES`."""
    if da.device.type == "cpu":
        return dwconv_gelu_bwd_plain(da, c, h, dw, hw)
    dev = _on_cuda("dwconv_gelu_bwd", da, c, h, dw)
    m, ch = da.shape
    f32 = dw.dtype == torch.float32
    _require(da.dtype == torch.float32 and c.dtype == h.dtype
             and c.dtype in ((torch.float32,) if f32 else (torch.float32, torch.bfloat16))
             and dw.dtype in (torch.float32, torch.bfloat16) and c.shape == (m, ch)
             and h.shape == (m, ch) and dw.shape == (9, ch),
             "dwconv_gelu_bwd: float32 da, c and h (M, C) both float32 or "
             "both bf16, and dw (9, C) bf16, or float32 with float32 c and h")
    _require(ch % DWB_CHUNK == 0 and m % (hw * hw) == 0 and m > 0,
             f"dwconv_gelu_bwd: needs C % {DWB_CHUNK} == 0 and (B*hw*hw, C) rows")
    plan = dwconv_gelu_bwd_plan(m // (hw * hw), hw, ch, c.dtype)
    dhid = torch.empty((m, ch), dtype=dw.dtype, device=dev)
    sums = torch.empty((11, ch), dtype=torch.float32, device=dev)
    ws = torch.empty((plan.rows * 11, ch), dtype=torch.float32, device=dev)
    counters = _zeroed_counters(dev, plan.chunks)
    lib = load_library()
    if f32:
        _f32().LAUNCHES["dwconv_gelu_bwd_f32"] += 1
    else:
        _count("dwconv_gelu_bwd")
    _check_launch(lib.ltd_dwconv_gelu_bwd(_ptr(da), _ptr(c), _ptr(h), _ptr(dw),
                                          _ptr(dhid), _ptr(ws), _ptr(sums), _ptr(counters),
                                          plan.images, hw, ch, plan.band,
                                          int(c.dtype == torch.bfloat16), int(f32), _stream(dev)),
                  "dwconv_gelu_bwd")
    return dhid, sums[:9], sums[9], sums[10]


def self_attention_bwd(qkv, dout, n_heads: int, n_tokens: int):
    """Kernel wrapper of `self_attention_bwd_plain`: one kernel, one launch
    counted. On CUDA: qkv bf16, dout float32, head dim 64 and N <= 256 (a
    ragged last 64-token tile is masked in the kernel); float32 qkv takes
    the float32 body (`fused_layer_vjp_f32.self_attention_bwd_f32`, two
    kernels, counted there)."""
    if qkv.device.type == "cpu":
        return self_attention_bwd_plain(qkv, dout, n_heads, n_tokens)
    if qkv.dtype == torch.float32:
        return _f32().self_attention_bwd_f32(qkv, dout, n_heads, n_tokens)
    dev = _on_cuda("self_attention_bwd", qkv, dout)
    m, three_d = qkv.shape
    d = three_d // 3
    _require(qkv.dtype == torch.bfloat16 and dout.dtype == torch.float32
             and dout.shape == (m, d) and d == 64 * n_heads,
             "self_attention_bwd: qkv bf16 (B*N, 3D), dout float32 (B*N, D), "
             "head dim 64")
    _require(0 < n_tokens <= 256 and m % n_tokens == 0,
             f"self_attention_bwd: needs N <= 256 and (B*N) rows, got {n_tokens}")
    _require(fs.tma_operand(qkv) and fs.tma_operand(dout),
             "self_attention_bwd: qkv and dout must be contiguous and 16-byte aligned")
    dqkv = torch.empty_like(qkv)
    lib = load_library()
    _count("self_attention_bwd")
    _check_launch(lib.ltd_self_attention_bwd(_ptr(qkv), _ptr(dout), _ptr(dqkv),
                                             m // n_tokens, n_tokens, d, n_heads,
                                             _stream(dev)), "self_attention_bwd")
    return dqkv


def cross_attention_bwd(qc, kv, dout, n_heads: int, n_tokens: int):
    """Kernel wrapper of `cross_attention_bwd_plain`. On CUDA: qc and kv
    both bf16 or both float32, dout float32, head dim 64 (any number of
    heads). Float32 qc and kv take the body's float32 instance (float32
    dqc and dkv), counted as "cross_attention_bwd_f32" in
    `fused_layer_vjp_f32.LAUNCHES`."""
    if qc.device.type == "cpu":
        return cross_attention_bwd_plain(qc, kv, dout, n_heads, n_tokens)
    dev = _on_cuda("cross_attention_bwd", qc, kv, dout)
    m, d = qc.shape
    b = m // n_tokens
    _require(qc.dtype == kv.dtype and qc.dtype in (torch.bfloat16, torch.float32)
             and dout.dtype == torch.float32 and dout.shape == (m, d)
             and kv.shape == (2 * b, 2 * d) and d == 64 * n_heads
             and m == b * n_tokens,
             "cross_attention_bwd: qc (B*N, D) and kv (2B, 2D) both bf16 or both "
             "float32, dout float32 (B*N, D), head dim 64")
    dqc = torch.empty_like(qc)
    dkv = torch.empty_like(kv)
    lib = load_library()
    if qc.dtype == torch.float32:
        _f32().LAUNCHES["cross_attention_bwd_f32"] += 1
        entry, name = lib.ltd_cross_attention_bwd_f32, "cross_attention_bwd_f32"
    else:
        _count("cross_attention_bwd")
        entry, name = lib.ltd_cross_attention_bwd, "cross_attention_bwd"
    _check_launch(entry(_ptr(qc), _ptr(kv), _ptr(dout), _ptr(dqc), _ptr(dkv), b, n_tokens,
                        d, n_heads, _stream(dev)), name)
    return dqc, dkv


# ------------------------------ the layer through the kernels ------------------------------


def _attn_pair_forward(x, cond, attn_params, n_heads: int, keep: bool,
                       ln3=None, bf16res: bool = False):
    """The attention pair's forward through the kernels (the first seven
    parameters of PARAM_NAMES), up to the float32 residual x2 and, with
    ln3, its bf16 LayerNorm xn3 (cross_attention's epilogue). keep=True
    (the backward's recompute) also writes what the backward reads: the
    normalised rows xn1 and xn2 and the residuals x0, x1, x2 as separate
    tensors. keep=False (the forward) updates one float32 residual in
    place and writes none of those. bf16res (with keep): the residuals are
    kept in the weights' dtype instead, x0 the input rows as given, x1 and
    x2 rounded where the float32 copies would be cloned; the one float32
    residual is updated in place."""
    ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv = attn_params
    b, n, d = x.shape
    lp = wqkv.dtype
    x0 = x.reshape(b * n, d).to(torch.float32, copy=True)
    c2 = cond.reshape(b * 2, d).to(lp).contiguous()

    def residual(t):  # the attention kernels add into it in place
        return t.clone() if keep and not bf16res else t

    def kept(t):  # what the backward reads of a residual
        return t.to(lp) if bf16res else t

    def ln_product(t, w, ln):  # (product, normalised rows or None)
        out = fs.ln_gemm(t, w, ln=ln, return_xn=keep)
        return out if keep else (out, None)

    qkv, xn1 = ln_product(x0, wqkv, (ln1s, ln1b))
    x0_kept = x.reshape(b * n, d).to(lp) if bf16res else x0
    x1 = fs.self_attention(qkv, residual(x0), n_heads, n)
    qc, xn2 = ln_product(x1, wq, (ln2s, ln2b))
    kv = fs.ln_gemm(c2, wkv)
    x1_kept = kept(x1)  # before cross_attention updates it in place
    x2, xn3 = fs.cross_attention(qc, kv, residual(x1), ln3, n_heads, n)
    return dict(x0=x0_kept, c2=c2, qkv=qkv, xn1=xn1, x1=x1_kept, qc=qc,
                xn2=xn2, kv=kv, x2=kept(x2), xn3=xn3)


def _layer_forward(x, cond, params, n_heads: int, hw: int, keep: bool,
                   bf16res: bool = False):
    """The layer forward through the kernels up to the GELU output, with
    `_attn_pair_forward`'s `keep` and `bf16res`; keep=True also writes the
    pre-GELU c. bf16res: the expanded h and c are bf16 too."""
    ln3s, ln3b, w1, b1, dw, dwb = params[7:13]
    r = _attn_pair_forward(x, cond, params[:7], n_heads, keep, (ln3s, ln3b),
                           bf16res)
    res_dtype = w1.dtype if bf16res else torch.float32
    h = fs.ln_gemm(r["xn3"], w1, bias=b1, out_dtype=res_dtype)
    a, c = (fs.dwconv_gelu(h, dw, dwb, hw, return_c=True, c_dtype=res_dtype)
            if keep else (fs.dwconv_gelu(h, dw, dwb, hw), None))
    r.update(h=h, c=c, a=a)
    return r


def fused_layer_fwd(x, cond, params: Sequence[torch.Tensor], n_heads: int,
                    hw: int):
    """The layer forward (`_fwd_kernel`) through the kernels: x (B, N, D),
    cond (B, 2, D); the result in x's dtype."""
    r = _layer_forward(x, cond, params, n_heads, hw, keep=False)
    out = fs.ln_gemm(r["a"], params[13], bias=params[14], residual=r["x2"])
    return out.reshape(x.shape).to(x.dtype)


def _dx_of(dy, w):
    """dY W in float32 (`ln_gemm` reading W (out, in) as stored, the
    MN-major operand: no transposed copy)."""
    return fs.ln_gemm(dy, w, out_dtype=torch.float32, w_transposed=True)


def _attn_pair_bwd(r, dx2, attn_params, n_heads: int, n: int,
                   cross: bool = True, self_attn: bool = True):
    """The attention pair's backward through the kernels, from the float32
    gradient dx2 (B*N, D) at x2 and `_attn_pair_forward(keep=True)`'s
    tensors `r`: (dx (B*N, D), dcond (B*2, D), both float32, the seven
    parameter gradients float32). cross=False or self_attn=False skips
    that attention's section as `_attn_pair_bwd_plain` does."""
    ln1s, _, wqkv, ln2s, _, wq, wkv = attn_params
    dx1, dcond, ds2, db2, dwq, dwkv = dx2, None, None, None, None, None
    if cross:
        dqc, dkv = cross_attention_bwd(r["qc"], r["kv"], dx2, n_heads, n)
        dwq = weight_grad(dqc, r["xn2"])
        dwkv = weight_grad(dkv, r["c2"])
        dcond = _dx_of(dkv, wkv)
        dx1, ds2, db2 = layernorm_bwd(_dx_of(dqc, wq), r["x1"], ln2s, dx2)
        del dqc, dkv

    dx, ds1, db1, dwqkv = dx1, None, None, None
    if self_attn:
        dqkv = self_attention_bwd(r["qkv"], dx1, n_heads, n)
        dwqkv = weight_grad(dqkv, r["xn1"])
        dx, ds1, db1 = layernorm_bwd(_dx_of(dqkv, wqkv), r["x0"], ln1s, dx1)
    return dx, dcond, [ds1, db1, dwqkv, ds2, db2, dwq, dwkv]


def fused_layer_bwd_variant(mode: str, x, cond, g,
                            params: Sequence[torch.Tensor], n_heads: int,
                            hw: int):
    """`fused_layer_bwd_variant_plain` through the kernels: the layer
    backward (`_bwd_kernel`, mode "full") recomputing the forward, or one
    of S2's ablations of it (`BWD_MODES`). Every mode runs the whole
    recompute (`_layer_forward(keep=True)`), as the TPU variants keep it
    alive; "recompute" stops there. (dx in x's dtype, dcond in cond's
    dtype, the 15 parameter gradients in float32 shaped like the
    parameters), None for what the mode does not compute."""
    _require(mode in BWD_MODES, f"fused_layer_bwd: mode is one of {BWD_MODES}")
    ln3s, _, w1, _, dw, _, w2, _ = params[7:]
    b, n, d = x.shape
    r = _layer_forward(x, cond, params, n_heads, hw, keep=True,
                       bf16res=mode == "bf16res")
    if mode == "recompute":
        return _bwd_outputs(r["x2"], None, [None] * len(params), x, cond, params)
    lp = w2.dtype
    g32 = g.reshape(b * n, d).float()
    dx2, mlp_grads = g32, [None] * 8
    if mode != "no_mlp":
        g_lp = g32.to(lp)
        db2 = colsum(g32)
        dw2 = weight_grad(g_lp, r["a"])
        dhid, ddw, ddwb, db1 = dwconv_gelu_bwd(_dx_of(g_lp, w2), r["c"], r["h"],
                                               dw, hw)
        dw1 = weight_grad(dhid, r["xn3"])
        dx2, ds3, db3 = layernorm_bwd(_dx_of(dhid, w1), r["x2"], ln3s, g32)
        mlp_grads = [ds3, db3, dw1, db1, ddw, ddwb, dw2, db2]
    del r["h"], r["c"], r["a"]
    dx, dcond, attn_grads = _attn_pair_bwd(r, dx2, params[:7], n_heads, n,
                                           cross=mode != "no_cross",
                                           self_attn=mode != "no_self")
    return _bwd_outputs(dx, dcond, attn_grads + mlp_grads, x, cond, params)


def fused_layer_bwd(x, cond, g, params: Sequence[torch.Tensor], n_heads: int,
                    hw: int):
    """The layer backward (`_bwd_kernel`) through the kernels, recomputing
    the forward: (dx in x's dtype, dcond in cond's dtype, the 15 parameter
    gradients in float32, shaped like the parameters)."""
    return fused_layer_bwd_variant("full", x, cond, g, params, n_heads, hw)


class FusedLayerFunction(torch.autograd.Function):
    """One decoder layer as an autograd function over the kernels (their
    plain versions on CPU tensors). The forward saves only (x, cond,
    params), as the TPU kernel's `_vjp_fwd_real` does; the backward
    recomputes. The parameter gradients come back in each parameter's
    dtype (bf16 for the projections and taps, float32 for the LayerNorm
    scales and shifts and the biases); dx and dcond in theirs."""

    @staticmethod
    def forward(ctx, x, cond, n_heads: int, hw: int, *params):
        ctx.save_for_backward(x, cond, *params)
        ctx.n_heads, ctx.hw = n_heads, hw
        return fused_layer_fwd(x, cond, params, n_heads, hw)

    @staticmethod
    def backward(ctx, g):
        x, cond, *params = ctx.saved_tensors
        dx, dcond, grads = fused_layer_bwd(x, cond, g.contiguous(), params,
                                           ctx.n_heads, ctx.hw)
        return (dx, dcond, None, None,
                *(gr.to(p.dtype) for gr, p in zip(grads, params)))


def fused_layer(x, cond, params: List[torch.Tensor], n_heads: int, hw: int):
    """Differentiable decoder layer; params in `PARAM_NAMES` order."""
    return FusedLayerFunction.apply(x, cond, n_heads, hw,
                                    *(p.contiguous() for p in params))
