"""The differentiable attention pair of the training step (TPU kernel K6),
composed of hand-written CUDA kernels, and its plain PyTorch versions.

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

It is K2's attention half (`ops/fused_layer_vjp.py`, whose helpers it
shares) with the upstream gradient entering at x2, since there is no MLP
stage:

  forward   ln_gemm          qkv = LN1(x) Wqkv^T (LayerNorm prologue)
            self_attention   x1 = x + SA(qkv), the float32 residual
            ln_gemm          qc = LN2(x1) Wq^T
            ln_gemm          kv = cond Wkv^T
            cross_attention  x2 = x1 + CA(qc, kv) (no LN3 epilogue)
  backward  the forward recomputed (five launches, keeping xn1, xn2 and
            the residuals), then
            cross_attention_bwd  dqc, dkv from g
            weight_grad (2)      dWq = dqc^T xn2, dWkv = dkv^T cond
            ln_gemm (2)          dcond = dkv Wkv, dxn2 = dqc Wq
            layernorm_bwd        dx1 = g + LN2's backward, dLN2
            self_attention_bwd   dqkv from dx1
            weight_grad          dWqkv = dqkv^T xn1
            ln_gemm              dxn1 = dqkv Wqkv
            layernorm_bwd        dx = dx1 + LN1's backward, dLN1
            (weight_grad sums its split-M partials itself and
            layernorm_bwd's row-block partials are summed by `colsum`:
            deterministic, no atomics)

Rounding points are the TPU kernel's: qkv, qc and kv rounded to the
weights' dtype after float32 accumulation; the softmax in float32 with p
rounded before p v; in the backward the per-head slices of g and dx1,
ds, dqc, dkv and dqkv rounded before their products; every sum float32;
dcond in cond's dtype and each parameter gradient cast to its
parameter's dtype (`_vjp_bwd`, :328-340). The TPU kernel sums the
softmax denominator with a float32 ones-matmul (`_rowsum_mxu`); here it is
a float32 sum, which differs in order only.

What bounds it on the H100 at the training shapes (B = 128, N = 256,
D = 768, 12 heads): the forward's products, about 0.18 TFLOP (QKV 116
GFLOP, Q 39, attention 26), at the bf16 tensor peak; the backward with its
recompute about 0.56 TFLOP. The kernels are K1's and K2's (their notes in
`csrc/`); the float32 residuals and gradients between them cross device
memory, traffic the TPU kernel keeps in VMEM.

With float32 weights (float32 training) every stage is the float32 body
of its kernel (`ops/fused_stack_f32.py`, `ops/fused_layer_vjp_f32.py`)
and nothing is rounded; the launches count under those bodies' names.

`fused_attention_pair_fwd_plain` / `fused_attention_pair_bwd_plain` write
the TPU kernels out in one piece; `fused_attention_pair_vjp` (an autograd
function, `FusedAttnPairFunction`) runs the kernels for CUDA tensors, or
raises, and the plain versions for CPU tensors. Parameters use the port's
(reference torch) layouts: projections (out, in), LayerNorm scales and
shifts as vectors.
"""

from __future__ import annotations

from typing import Dict

import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

PARAM_NAMES = lv.PARAM_NAMES[:7]

KERNELS = ("fused_attention_pair_vjp", "fused_attention_pair_vjp_bwd")
# calls that launched the kernels since the last reset_launch_counts(); the
# launches themselves count under their kernels' names: the forward's
# under "ln_gemm" (3), "self_attention" and "cross_attention" in
# fused_stack.LAUNCHES, the backward's under those (the recompute) and
# "ln_gemm" (3 more) there, and under "cross_attention_bwd",
# "weight_grad" (3), "layernorm_bwd" (2), "self_attention_bwd" and
# "colsum" (layernorm_bwd's partial sums) in
# fused_layer_vjp.LAUNCHES
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


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
                f"plain version); got {x.device}")
    fs._require(x.dim() == 3 and cond.shape == (x.shape[0], 2, x.shape[2]),
                f"{name}: x must be (B, N, D) and cond (B, 2, D)")


def fused_attention_pair_fwd(x, cond, ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv,
                             n_heads: int):
    """Kernel route of `fused_attention_pair_fwd_plain` (same arguments and
    result): on CUDA five launches (module docstring), x, cond and the
    projections bf16, the LayerNorm parameters float32; on CPU tensors the
    plain version."""
    params = (ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv)
    if x.device.type == "cpu":
        return fused_attention_pair_fwd_plain(x, cond, *params, n_heads)
    _require_cuda("fused_attention_pair_vjp", x, cond)
    r = lv._attn_pair_forward(x.contiguous(), cond.contiguous(), params,
                              n_heads, keep=False)
    LAUNCHES["fused_attention_pair_vjp"] += 1
    return r["x2"].reshape(x.shape).to(x.dtype)


def fused_attention_pair_bwd(x, cond, g, ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv,
                             n_heads: int):
    """Kernel route of `fused_attention_pair_bwd_plain` (same arguments and
    results): on CUDA the forward's five launches again, then the
    backward's (module docstring); on CPU tensors the plain version."""
    params = (ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv)
    if x.device.type == "cpu":
        return fused_attention_pair_bwd_plain(x, cond, g, *params, n_heads)
    _require_cuda("fused_attention_pair_vjp (backward)", x, cond)
    b, n, d = x.shape
    r = lv._attn_pair_forward(x.contiguous(), cond.contiguous(), params,
                              n_heads, keep=True)
    dx, dcond, grads = lv._attn_pair_bwd(
        r, g.reshape(b * n, d).float(), params, n_heads, n)
    LAUNCHES["fused_attention_pair_vjp_bwd"] += 1
    return (dx.reshape(b, n, d).to(x.dtype),
            dcond.reshape(b, 2, d).to(cond.dtype),
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
