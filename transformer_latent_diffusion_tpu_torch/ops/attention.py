"""Multi-head attention: the flash-attention kernel (TPU kernel K3), its
backward (TPU kernel K4) and their plain PyTorch versions.

Counterpart of the JAX package's `ops/attention.py`: `_xla_attention`
(the plain math), `_pallas_attention` / `_flash_kernel` (K3: one program
per (batch*head, 256-query block) with the whole K/V of the head in VMEM
and a float32 softmax), `multi_head_attention`, which takes the kernel for
every attention with at least 8 queries and 8 keys when `use_pallas` is
set (`_pallas_ok`, :122-129), and the custom VJP `_attention_core`, whose
backward `_attention_bwd` (:349-368) takes K4a (`_pallas_attention_bwd`,
the whole N x N set of one head in VMEM) for 512 <= N <= 2048 with
N % 128 == 0, K4b (`_pallas_attention_bwd_tiled`, 512-query blocks) for
N % 512 == 0 up to 8192, and XLA's recompute otherwise. Tokens keep the
JAX package's (B, N, D) layout at the public function.

Here the forward kernel is `csrc/flash_attention.cu`: a Hopper SM cannot
hold a head's K and V at 1024-4096 tokens, so it streams them in 64-key
tiles with an online softmax. The wrapper hands it q, k and v as the
(B*N, D) row views they are (for self-attention, the three column blocks
of the fused QKV projection), without transposes, and it writes (B*N, D)
rows. With a gradient asked for, `FlashAttentionFunction` runs it with each
row's float32 log-sum-exp as a second output, and its backward takes the
route `attention_bwd_route` names: for "k4a" and "k4b" the one Hopper
kernel of both, `csrc/flash_attention_bwd.cu` (`flash_attention_bwd`), and
for "plain", where the JAX package runs XLA, torch autograd through
`attention_plain`. On CPU tensors the wrappers run the plain versions
(`attention_plain`, `attention_bwd_plain`); on any other device they
launch the kernels or raise.

Float32 q, k and v (the JAX package's default compute dtype on the linen
path: 512 and 1024 px deployments, the "mlp" and "moe" FFNs, a model
sampled on another grid) take K3's float32 body,
`csrc/flash_attention_f32.cu` (`flash_attention_f32`): the same streaming
over 64-key chunks, each float32 product run on the tensor cores as three
TF32 products of the operands' parts (3xTF32), the probabilities not
rounded, a float32 output. Its launches count in `LAUNCHES` apart from
the bf16 body's. With a gradient asked for (float32 training past 256
tokens) it also writes each row's log-sum-exp, and the "k4a" and "k4b"
routes take the backward's float32 body,
`csrc/flash_attention_bwd_f32.cu` (`flash_attention_bwd_f32`, counted
apart too): the bf16 body's two kernels (dq, then dk/dv) with each
product run as 3xTF32, p and ds not rounded, as the TPU kernels compute
with float32 inputs.

The probe scripts/probe_attn_softmax.py (S3) times four softmax forms of
the same attention: `flash_attention_variant` runs them as template
flags of the same kernel (exp or exp2; p normalised before it is rounded,
"prediv", in two passes over the keys, or after P V, "postdiv", K3's own
form), and `attention_variant_plain` is their plain version.
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

KERNELS = ("flash_attention", "flash_attention_f32", "flash_attention_bwd",
           "flash_attention_bwd_f32", "flash_attention_variant")
# launches of each kernel since the last reset_launch_counts()
# (flash_attention_bwd and its float32 body are two kernels each, dq then
# dk/dv, and count both)
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# the kernels' head width (csrc/flash_attention*.cu)
HEAD_DIM = 64
# the JAX package's gate (_pallas_ok): at least this many queries and keys
MIN_TOKENS = 8
# the JAX package's backward gates (_attention_bwd): K4a's token range, and
# K4b's limit
K4A_MIN_TOKENS, K4A_MAX_TOKENS = 512, 2048
K4B_MAX_TOKENS = 8192
# the backward kernel's query and key tiles
BWD_TILE = 64
LOG2E = 1.4426950408889634


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


def attention_bwd_plain(q, k, v, g):
    """(dq, dk, dv) of `attention_plain` as the TPU kernels K4a/K4b compute
    them (`_flash_bwd_kernel`, :205-237; the tiled kernel computes the same
    function): the float32 scores and softmax recomputed, dp = g v^T,
    ds = p (dp - rowsum(p dp)), then ds / sqrt(dh) and p rounded to the
    inputs' dtype, dq = ds k, dk = ds^T q, dv = p^T g with float32 sums,
    each in its input's dtype. All (B, H, N, dh)."""
    dh = q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dp = g.float() @ v.float().transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    ds_lp = (ds * scale).to(q.dtype).float()
    p_lp = p.to(v.dtype).float()
    dq = ds_lp @ k.float()
    dk = ds_lp.transpose(-1, -2) @ q.float()
    dv = p_lp.transpose(-1, -2) @ g.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_route(nq: int, nk: int, dh: int) -> str:
    """The JAX package's choice of backward (`_attention_bwd`, with its
    `_pallas_ok` gate): "k4a" (`_pallas_attention_bwd`) for self-attention
    of 512 <= N <= 2048 tokens with N % 128 == 0, "k4b"
    (`_pallas_attention_bwd_tiled`) for N % 512 == 0 up to 8192, else
    "plain" (XLA's recompute there, chunked or one-shot). The port runs
    both kernel routes through `flash_attention_bwd`."""
    if nq >= MIN_TOKENS and nk >= MIN_TOKENS and dh % 8 == 0 and nq == nk:
        if K4A_MIN_TOKENS <= nq <= K4A_MAX_TOKENS and nq % 128 == 0:
            return "k4a"
        if nq % 512 == 0 and nq <= K4B_MAX_TOKENS:
            return "k4b"
    return "plain"


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
    _require(t.stride(1) * t.element_size() % 16 == 0 and t.data_ptr() % 16 == 0,
             f"flash_attention: {name}'s rows must be 16-byte aligned")
    return t.stride(1)


def _cuda_device(t) -> torch.device:
    """The device of a kernel's operand, which must be a CUDA one."""
    if t.device.type != "cuda":
        raise ValueError(f"flash_attention: the kernel runs on CUDA tensors "
                         f"(CPU tensors take the plain version); got {t.device}")
    return t.device


def _check_qkv(q, k, v, n_heads: int) -> torch.device:
    """The device of q, k and v, all bf16 or all float32 (the two bodies)."""
    dev = _cuda_device(q)
    b, nq, d = q.shape
    nk = k.shape[1]
    for name, t in (("k", k), ("v", v)):
        _require(t.device == dev, f"flash_attention: {name} on {t.device}, q on {dev}")
    _require(q.dtype in (torch.bfloat16, torch.float32)
             and k.dtype == q.dtype and v.dtype == q.dtype,
             "flash_attention: q, k and v must be all bf16 or all float32")
    _require(d == HEAD_DIM * n_heads and k.shape == (b, nk, d) and v.shape == k.shape,
             f"flash_attention: needs head dim {HEAD_DIM} and k, v (B, Nk, D)")
    _require(nq >= MIN_TOKENS and nk >= MIN_TOKENS,
             f"flash_attention: needs at least {MIN_TOKENS} queries and keys")
    return dev


def _flash_forward(q, k, v, n_heads: int, with_lse: bool = False):
    """(out, lse): the kernel's output and, with_lse, each query row's
    float32 log-sum-exp (B, H, Nq), else None. CPU tensors: the plain
    version and no lse; bf16 ones the bf16 body, float32 ones the float32
    body (`flash_attention_f32`)."""
    if q.device.type == "cpu":
        return _mha_plain(q, k, v, n_heads), None
    dev = _check_qkv(q, k, v, n_heads)
    b, nq, d = q.shape
    strides = [_row_stride(name, t) for name, t in (("q", q), ("k", k), ("v", v))]
    name = "flash_attention_f32" if q.dtype == torch.float32 else "flash_attention"
    out = torch.empty((b, nq, d), dtype=q.dtype, device=dev)
    lse = (torch.empty((b, n_heads, nq), dtype=torch.float32, device=dev)
           if with_lse else None)
    lib = load_library()
    LAUNCHES[name] += 1
    err = getattr(lib, f"ltd_{name}")(_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), b,
                                      nq, k.shape[1], n_heads, *strides, _stream(dev))
    _check_launch(err, name)
    return out, lse


def flash_attention_bwd(q, k, v, g, n_heads: int, o=None, lse=None):
    """Kernel wrapper of `attention_bwd_plain` on (B, N, D) tokens: returns
    (dq, dk, dv), each (B, N, D) with the heads merged.

    On CUDA: self-attention (Nq == Nk) with N % 64 == 0, q, k, v, g and
    the forward's output o all bf16 (the bf16 body) or all float32 (the
    float32 body, `flash_attention_bwd_f32`) with head dim 64, each a view
    of evenly spaced rows with unit column stride; lse the forward's
    (B, H, N) float32 log-sum-exp. Two launches: dq (which also writes
    rowsum(g o)), then dk and dv. On CPU tensors the plain version (o and
    lse unused)."""
    if q.device.type == "cpu":
        grads = attention_bwd_plain(*(_heads(t, n_heads) for t in (q, k, v, g)))
        return tuple(_merge(t) for t in grads)
    dev = _check_qkv(q, k, v, n_heads)
    b, n, d = q.shape
    _require(k.shape[1] == n and n % BWD_TILE == 0,
             f"flash_attention_bwd: needs Nq == Nk and N % {BWD_TILE} == 0")
    _require(o is not None and lse is not None,
             "flash_attention_bwd: needs the forward's output o and lse")
    for name, t in (("o", o), ("g", g)):
        _require(t.device == dev and t.dtype == q.dtype and t.shape == q.shape,
                 f"flash_attention_bwd: {name} must be {q.dtype} (B, N, D) on {dev}")
    _require(lse.device == dev and lse.dtype == torch.float32 and lse.is_contiguous()
             and lse.shape == (b, n_heads, n) and lse.data_ptr() % 16 == 0,
             "flash_attention_bwd: lse must be contiguous 16-byte aligned float32 (B, H, N)")
    strides = [_row_stride(name, t) for name, t in
               (("q", q), ("k", k), ("v", v), ("o", o), ("g", g))]
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty((b, n, d), dtype=q.dtype, device=dev) for _ in range(3))
    name = "flash_attention_bwd_f32" if q.dtype == torch.float32 else "flash_attention_bwd"
    lib = load_library()
    stream = _stream(dev)
    LAUNCHES[name] += 1
    _check_launch(getattr(lib, f"ltd_{name}_dq")(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(g), _ptr(lse), _ptr(delta), _ptr(dq),
        b, n, n_heads, *strides, stream), f"{name} (dq)")
    LAUNCHES[name] += 1
    _check_launch(getattr(lib, f"ltd_{name}_dkv")(
        _ptr(q), _ptr(k), _ptr(v), _ptr(g), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv),
        b, n, n_heads, *strides[:3], strides[4], stream), f"{name} (dk, dv)")
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Attention on (B, N, D) tokens as an autograd function: the forward
    is K3 (`flash_attention`'s kernel, with the row log-sum-exp where the
    backward kernel will read it); the backward takes
    `attention_bwd_route`'s choice: `flash_attention_bwd` for "k4a" and
    "k4b", torch autograd through the plain math for "plain". The forward
    saves q, k, v, its output and the log-sum-exp. bf16 and float32
    operands each take their dtype's bodies."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads: int):
        route = attention_bwd_route(q.shape[1], k.shape[1], q.shape[2] // n_heads)
        out, lse = _flash_forward(q, k, v, n_heads, with_lse=route != "plain")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.n_heads, ctx.route = n_heads, route
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.route == "plain":
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
                o = _mha_plain(*leaves, ctx.n_heads)
                grads = torch.autograd.grad(o, leaves, g)
        else:
            grads = flash_attention_bwd(q, k, v, g.contiguous(), ctx.n_heads,
                                        o=out, lse=lse)
        return (*grads, None)


def flash_attention(q, k, v, n_heads: int):
    """Kernel wrapper of `attention_plain` on (B, N, D) tokens: returns
    (B, Nq, D) with the heads merged, like `multi_head_attention`;
    differentiable (`FlashAttentionFunction`) where a gradient is asked for.

    On CUDA: q, k, v all bf16 (K3's bf16 body) or all float32 (its float32
    body, `flash_attention_f32`) with head dim 64, Nq and
    Nk >= 8, each a view of evenly spaced rows with unit column stride
    (the column blocks of a fused projection are)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, n_heads)
    return _flash_forward(q, k, v, n_heads)[0]


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


# ------------------------------ S3: the softmax variants ------------------------------


def attention_variant_plain(q, k, v, n_heads: int, use_exp2: bool, postdiv: bool):
    """The probe's `_kernel` (scripts/probe_attn_softmax.py) on (B, N, D)
    tokens, heads split and merged: float32 scores s = q k^T / sqrt(dh)
    over the whole key row, m its max, e = exp2((s - m) log2 e) or
    exp(s - m), z = sum(e); postdiv: (bf16(e) v) / z, prediv: bf16(e / z)
    v, the products in float32; the result in v's dtype."""
    qh, kh, vh = (_heads(t, n_heads) for t in (q, k, v))
    dh = qh.shape[-1]
    s = (qh.float() @ kh.float().transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    m = s.amax(-1, keepdim=True)
    e = torch.exp2((s - m) * LOG2E) if use_exp2 else torch.exp(s - m)
    z = e.sum(-1, keepdim=True)
    if postdiv:
        out = (e.to(v.dtype).float() @ vh.float()) / z
    else:
        out = (e / z).to(v.dtype).float() @ vh.float()
    return _merge(out.to(v.dtype))


def flash_attention_variant(q, k, v, n_heads: int, use_exp2: bool, postdiv: bool):
    """Kernel wrapper of `attention_variant_plain` (no gradient): q, k, v as
    `flash_attention` takes them, (B, N, D) views of evenly spaced rows.
    The probe's (B, H, N, 64) heads are (B*H, N, 64) rows with one head.
    The kernel keeps a running max, so postdiv rounds e against it where
    the plain version uses the row's final max (about one bf16 step of p);
    prediv's two passes use the final max and sum, as the plain version."""
    if q.device.type == "cpu":
        return attention_variant_plain(q, k, v, n_heads, use_exp2, postdiv)
    dev = _check_qkv(q, k, v, n_heads)
    _require(q.dtype == torch.bfloat16, "flash_attention_variant: q, k and v must be bf16")
    b, nq, d = q.shape
    strides = [_row_stride(name, t) for name, t in (("q", q), ("k", k), ("v", v))]
    out = torch.empty((b, nq, d), dtype=torch.bfloat16, device=dev)
    lib = load_library()
    LAUNCHES["flash_attention_variant"] += 1
    err = lib.ltd_flash_attention_variant(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), b, nq, k.shape[1], n_heads, *strides,
        int(use_exp2), int(not postdiv), _stream(dev))
    _check_launch(err, "flash_attention_variant")
    return out
