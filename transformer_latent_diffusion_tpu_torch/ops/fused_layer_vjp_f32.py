"""The float32 bodies of the training layers' backward: TPU kernels K2 and
K6 with a float32 compute dtype.

The JAX package's backward kernels run in the weights' dtype
(`mxu = wqkv.dtype`: `ops/fused_layer_vjp.py:118,141`, K2's `_bwd_kernel`
with `pallas_call` at :289; `ops/fused_attn_vjp.py:105,141`, K6's at :276),
so `TrainConfig(compute_dtype="float32")` trains through them in float32:
no operand is rounded, every product multiplies float32 operands with
float32 accumulation. The port's composition (`ops/fused_layer_vjp.py`,
`ops/fused_attn_vjp.py`) runs unchanged with float32 weights; its
wrappers send each float32 call to a float32 body:

  the recompute   `fused_stack_f32`'s bodies, with two training modes:
                  `ln_gemm_f32` also writing the float32 LayerNorm rows
                  (return_xn) and `dwconv_gelu_f32` the float32 c
  dX = dY W       `ln_gemm_f32` reading W (out, in) as stored
                  (w_transposed): csrc/ln_gemm_f32.cu
  weight_grad_f32          dW = dY^T X: csrc/gemm_bwd_f32.cu, 3xTF32 `wgmma`
                           over weight_grad's work plan (128 x 128 tiles,
                           32-row stages), both operands split and
                           transposed on chip
  self_attention_bwd_f32   csrc/flash_attention_bwd_f32.cu's two kernels
                           (K4's float32 body): dq, which first makes each
                           row's log-sum-exp and D = sum p dp from the keys,
                           then dk and dv; 3xTF32 `wgmma`, ragged N
  cross_attention_bwd_f32  csrc/attention_bwd.cu's SIMT body in float32
                           (`fused_layer_vjp.cross_attention_bwd`)
  dwconv_gelu_bwd_f32      csrc/dwconv_gelu_bwd.cu's TMA body with float32
                           taps and a float32 dhid
                           (`fused_layer_vjp.dwconv_gelu_bwd`)
  layernorm_bwd, colsum    float32 already (`fused_layer_vjp.LAUNCHES`)

Each body counts its launches in this module's `LAUNCHES`, apart from the
bf16 bodies' counts, so a float32 run shows no bf16 backward launch. The
plain versions are those of `ops/fused_layer_vjp.py`, which take any
dtype; CPU tensors run them. Past 256 tokens float32 training takes the
linen path's float32 bodies instead (`ops/attention.py`'s
`flash_attention_bwd` and `ops/fused_mlp_vjp.py`).
"""

from __future__ import annotations

from typing import Dict

import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.ops._build import load_library

KERNELS = ("weight_grad_f32", "self_attention_bwd_f32", "cross_attention_bwd_f32",
           "dwconv_gelu_bwd_f32")
# launches of each kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
F32 = torch.float32
# kernel launches of one float32 K2 layer's forward and backward (the
# backward recomputes the forward: keep=True), by module
K2_LAUNCHES_PER_LAYER = {
    "ln_gemm_f32": 14, "self_attention_f32": 2, "cross_attention_f32": 2,
    "dwconv_gelu_f32": 2, "weight_grad_f32": 5, "dwconv_gelu_bwd_f32": 1,
    "cross_attention_bwd_f32": 1, "self_attention_bwd_f32": 2,
    "layernorm_bwd": 3, "colsum": 4}
# ... and of one float32 K6 pair (the "mlp" and "moe" FFNs' blocks)
K6_LAUNCHES_PER_LAYER = {
    "ln_gemm_f32": 9, "self_attention_f32": 2, "cross_attention_f32": 2,
    "weight_grad_f32": 3, "cross_attention_bwd_f32": 1, "self_attention_bwd_f32": 2,
    "layernorm_bwd": 2, "colsum": 2}
# of which ln_gemm_f32's and dwconv_gelu_f32's training modes
# (`fused_stack_f32.MODE_LAUNCHES`): the recompute's LayerNorm products
# that keep their rows, the dX = dY W products and the recompute's c
K2_MODE_LAUNCHES_PER_LAYER = {"ln_gemm_f32 return_xn": 2, "ln_gemm_f32 w_transposed": 5,
                              "dwconv_gelu_f32 return_c": 1}
K6_MODE_LAUNCHES_PER_LAYER = {"ln_gemm_f32 return_xn": 2, "ln_gemm_f32 w_transposed": 3}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def weight_grad_f32(dy, x):
    """`lv.weight_grad_plain` for float32 dy (M, N) and x (M, K) on CUDA:
    float32 (N, K). N % 8 == 0 and K % 8 == 0 (ragged last tiles masked),
    any M; one launch, the split-M partials summed in the plan's fixed
    order."""
    dev = fs._on_cuda("weight_grad", dy, x)
    m, n = dy.shape
    k = x.shape[1]
    fs._require(dy.dtype == F32 and x.dtype == F32 and x.shape[0] == m and m > 0,
                "weight_grad: float32 dy (M, N) takes float32 x (M, K)")
    fs._require(n % 8 == 0 and k % 8 == 0,
                f"weight_grad: needs N % 8 == 0 and K % 8 == 0, got {n}, {k}")
    plan, table = lv._plan_on(m, n, k, dev, lv.WG_TILE_F32, lv.WG_STAGE_ROWS_F32)
    out = torch.empty((n, k), dtype=F32, device=dev)
    ws = torch.empty((max(plan.slabs, 1), lv.WG_TILE_F32[0] * lv.WG_TILE_F32[1]),
                     dtype=F32, device=dev)
    counters = torch.zeros(plan.tiles, dtype=torch.int32, device=dev)
    lib = load_library()
    LAUNCHES["weight_grad_f32"] += 1
    fs._check_launch(lib.ltd_weight_grad_f32(fs._ptr(dy), fs._ptr(x), fs._ptr(out), fs._ptr(ws),
                                             fs._ptr(counters), fs._ptr(table), m, n, k,
                                             plan.blocks, fs._stream(dev)),
                     "weight_grad_f32")
    return out


def self_attention_bwd_f32(qkv, dout, n_heads: int, n_tokens: int):
    """`lv.self_attention_bwd_plain` for float32 qkv (B*N, 3D) and dout
    (B*N, D) on CUDA: float32 dqkv. Head dim 64, N <= 256 (ragged N
    allowed). Two launches, counted both: dq, which also writes each row's
    log-sum-exp and D into a scratch of 2 B H ceil(N / 64) 64 floats, then
    dk and dv."""
    dev = fs._on_cuda("self_attention_bwd", qkv, dout)
    m, three_d = qkv.shape
    d = three_d // 3
    fs._require(qkv.dtype == F32 and dout.dtype == F32 and dout.shape == (m, d)
                and d == 64 * n_heads,
                "self_attention_bwd: float32 qkv (B*N, 3D) and dout (B*N, D), head dim 64")
    fs._require(0 < n_tokens <= 256 and m % n_tokens == 0,
                f"self_attention_bwd: needs N <= 256 and (B*N) rows, got {n_tokens}")
    fs._require(fs.tma_operand(qkv) and fs.tma_operand(dout),
                "self_attention_bwd: qkv and dout must be contiguous and 16-byte aligned")
    b = m // n_tokens
    stats = torch.empty((2, b, n_heads, -(-n_tokens // 64) * 64), dtype=F32, device=dev)
    dqkv = torch.empty_like(qkv)
    lib = load_library()
    stream = fs._stream(dev)
    for part in ("dq", "dkv"):
        LAUNCHES["self_attention_bwd_f32"] += 1
        fs._check_launch(getattr(lib, f"ltd_self_attention_bwd_f32_{part}")(
            fs._ptr(qkv), fs._ptr(dout), fs._ptr(stats), fs._ptr(dqkv), b, n_tokens, n_heads,
            stream), f"self_attention_bwd_f32 ({part})")
    return dqkv
