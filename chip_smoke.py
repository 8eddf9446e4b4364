"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from
`transformer_latent_diffusion_tpu_torch/csrc/` and drives the port's three
paths, each checked against plain PyTorch versions on the same inputs:

- serving (TPU kernel K1, the inference decoder layer): each kernel at the
  main path's shapes, one fused-engine forward against the plain bf16
  forward, the library entry point (32 images, 50-step DDIM, CFG 6,
  flagship 101M denoiser, random weights from a seed), the sampler's step
  loop as a CUDA graph (captured at a key's second call; its replay
  bit-equal to the eager loop, exact launches through the replays, one
  capture for calls with other prompts and seeds, a new one after
  `load_state_dict` and the memory it holds, the graph's and the eager
  loop's times; briefly also on the W8A8 engine and the 512 px linen
  path), what a key's graph costs on the HTTP default request's loop
  (its first calls, a mix of more keys than kept, a new generator per
  call), the sampler extras through the graph (heun, eta, cfg_rescale, a
  guidance interval, block caching; each engine call along the loop
  against the plain bf16 Denoiser's), the HTTP service on a real socket,
  the 256 px model sampled on a 32 x 32-token grid (resized
  positional table, the linen path with K3), and image editing through
  the K1 engine and the graph (`[editing]`: the full-width VAE encode
  against the CPU's, image_to_image and inpaint at 32 images x 50 steps
  with every engine call against the plain bf16 Denoiser's and
  inpainting's keep region bit-equal to the init latents, outpaint with
  the widened flagship, interpolate, the HTTP init_image and mask
  requests; and after the training phases the outpaint fine-tune through
  K2);
- float32 serving (K1 and K7 with the JAX package's default compute
  dtype, float32): the four float32 bodies (ops/fused_stack_f32.py) at the
  main path's shapes against their plain versions (TF32 off, rel-L2 within
  1e-5, two launches bit-equal, ptxas), one float32 engine forward against
  the plain float32 forward and the float32 W8A8 forward against its plain
  stack, the library entry point on the float32 flagship (32 images x 50
  DDIM steps) and its graph, the micro-batcher (`[microbatch]`: concurrent
  HTTP requests coalesced into one loop, batched images within one uint8
  step of their solo runs, a full queue answered 503 with Retry-After),
  and the service with no config, `LTDConfig()` as the JAX service builds
  it, three default requests over HTTP;
- int8 serving (TPU kernel K7, the W8A8 decoder layer): its two kernels
  (rowquant, gemm_i8) and the float32-out dwconv_gelu at the main path's
  shapes, one int8-engine forward against the plain int8 stack and the
  plain bf16 forward, the library entry point and the HTTP service on a
  `quantize="int8"` deployment, and S1 (the MLP product pair at
  scripts/microbench_int8.py's shapes, bf16 against W8A8);
- hi-res serving (TPU kernels K3, flash attention, and K5's forward, the
  fused sep-conv MLP): each at the 512 px and 1024 px shapes (and a ragged
  400-token grid), one 512 px Denoiser forward with the kernels against
  the plain bf16 forward, the library entry point on a 512 px deployment
  (the flagship's seeded weights with the positional table upsampled; 32
  images, 50-step DDIM, CFG 6), its HTTP service, and a 1024 px deployment
  (4 images x 20 DDIM steps, cut from 32 x 50 for time);
- training (TPU kernel K2, the differentiable decoder layer): each
  backward kernel at the flagship layer's shapes (batch 128), one layer's
  forward and backward against the plain layer, one train step's
  gradients against the plain bf16 autograd path, and `train.main` at
  batch 128 on random latents (20 steps, one eval through the K1 engine,
  a checkpoint, then a resume that continues the step count);
- the other FFNs (TPU kernel K6, the differentiable attention pair, and
  the K8 and K9 entry points): self_attention and its backward on ragged
  tiles (144 and 200 tokens), K6's forward and backward (all nine
  outputs) at batch 128 and on the ragged tiles, K8 and K9 at the 256 px
  serving shapes, each against its plain version (autograd through
  SDPA timed beside K6); for the flagship with the "moe" FFN (8 experts,
  capacity factor 1.25) and with the "mlp" FFN: one Denoiser forward
  (flash attention, no engine) against the plain bf16 forward, the
  library (8 images x 20 DDIM steps) and the HTTP service, one train
  step's gradients with K6 against the plain bf16 autograd path, ms per
  step and peak memory, and `train.main` (10 steps, an eval grid);
- hi-res training (TPU kernels K4a/K4b, the flash-attention backward, and
  K5's backward, the sep-conv MLP's): each at the 512 px and 1024 px
  shapes against its plain version, one 512 px step's gradients against
  the plain bf16 autograd path, ms per step and peak memory at 512 px
  (batch 64) and 1024 px (batch 16, remat), remat's gradients against
  no remat, `finetune_highres` from the 256 px flagship's seeded weights to
  512 px (16 steps, an eval, checkpoints), and `train.main` on a 512 px
  model with a 256 px bucket (multires).

It checks that each path's run launched its kernels the expected number
of times, and no other kernel of the port. Any failure raises: there is
no CPU fallback and no caught phase.

Output: one line per phase; then the card's name and power limit as
nvidia-smi reports them, one JSON line with every kernel's launches,
errors, times and bounds, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

# main-path shapes: CFG doubles batch 32 to 64; 16x16 tokens; flagship width
B, HW, D, HEADS = 64, 16, 768, 12
N, HIDDEN = HW * HW, 4 * 768
N_IMGS, N_ITER = 32, 50
# training shapes: the flagship step's batch (TrainConfig.batch_size)
TB = 128
TRAIN_STEPS = 20  # steps of the train.main run (one epoch)
# denoiser calls of one eval grid: eval_gen's 40 steps (each eval builds a
# new generator, whose one call runs the loop eagerly)
EVAL_CALLS = 40
DEVICE = "cuda"
TPU_KERNEL = "transformer_latent_diffusion_tpu/ops/fused_stack.py:120"
TPU_K2_FWD = "transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py:267"
TPU_K2_BWD = "transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py:289"
TPU_K3 = "transformer_latent_diffusion_tpu/ops/attention.py:99"
TPU_K5 = "transformer_latent_diffusion_tpu/ops/fused_mlp_vjp.py:186"
TPU_K4A = "transformer_latent_diffusion_tpu/ops/attention.py:247"
TPU_K4B = "transformer_latent_diffusion_tpu/ops/attention.py:313"
TPU_K5_BWD = "transformer_latent_diffusion_tpu/ops/fused_mlp_vjp.py:212"
TPU_K7 = "transformer_latent_diffusion_tpu/ops/fused_stack_int8.py:132"
# S1's x is (256, 256, 768): 65,536 rows through the MLP product pair
S1_ROWS = 256 * 256
# hi-res shapes: 512 px is a 32 x 32 grid (CFG doubles 32 images to 64),
# 1024 px a 64 x 64 grid (CFG doubles 4 images to 8); a ragged 20 x 20 grid
HR_HW, HR_B = 32, 64
HR_N = HR_HW * HR_HW
XR_N, XR_B = 64 * 64, 8
RAG_N, RAG_B = 400, 2
HR_IMGS, HR_ITER = 32, 50
XR_IMGS, XR_ITER = 4, 20  # 1024 px: cut from 32 x 50 for time
RESIZE_ITER = 4  # steps of the 256 px model sampled on the 512 px grid
# hi-res training: 512 px at batch 64 and 1024 px at batch 16 (the JAX
# package's documented fine-tune recipe); the 512 px gradient check at
# batch 8 (the plain path holds every layer's B x 12 x N^2 scores), K4's
# 4096-token check at batch 2 for the same reason, a third K4 size in
# K4a's range, and the 1024 px remat check at batch 2
HT_B, XT_B = 64, 16
HT_SIZE, XT_SIZE = 64, 128  # latent sizes: 1024 and 4096 tokens at patch 2
HT_GRAD_B, XT_GRAD_B, XR_CHECK_B = 8, 2, 2
K4_THIRD_N, K4_THIRD_B = 1536, 8
FT_STEPS = 16  # finetune_highres steps (one epoch)
MR_STEPS = 2  # multires: batches per bucket
# the card's published peaks (H100 SXM, dense, at 700 W): the least time
# of a kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate of their type
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOP_S = 989e12
INT8_TENSOR_OP_S = 1979e12
F32_FLOP_S = 67e12
# kernel vs plain version on the same inputs: rel-L2 and max-abs bounds
# (max-abs relative to the plain output's largest magnitude). The two
# accumulate the same bf16 products in float32 in different orders, so a
# bf16 output may differ by one rounding step (2^-8 relative).
KERNEL_REL_L2 = 1e-2
KERNEL_MAX_ABS = 2e-2
# one whole decoder layer, kernels vs the plain stack, rel-L2 of the layer's
# update: the one-step flips of the intermediate bf16 roundings propagate
# into the bf16 output, so a looser bound than for a single kernel
LAYER_REL_L2 = 2e-2
# one fused-engine forward vs the plain bf16 forward (rel-L2): measured
# 0.0106 on an H100 80GB HBM3 at 700 W (random flagship weights, batch 64);
# the bound leaves about 3x margin
ENGINE_REL_L2 = 0.03
# one 512 px Denoiser forward, kernels (K3, K5) vs the plain bf16 forward
# (rel-L2; the kernel route keeps the MLP's hidden state in float32, the
# plain one in bf16): measured 0.00996 on an H100 80GB HBM3 at 700 W
# (random weights, batch 64); the bound leaves about 3x margin
HIRES_MODEL_REL_L2 = 0.03
# rowquant against rowquant_plain: the LayerNorm statistics are summed in
# another order, so an int8 value may move by one, in at most this share
ROWQUANT_FLIP_SHARE = 1e-3
# gemm_i8 against gemm_i8_plain on the same int8 operands: integer sums
# are exact and the float32 epilogue rounds at the same points, so only
# this much of the output's scale is allowed
GEMM_I8_MAX_ABS = 1e-5
# one int8-engine forward, kernels vs the plain int8 stack on the card
# (rel-L2): the attention kernels' one-step bf16 differences (as in the
# bf16 engine) and rowquant's rare one-step flips, through 12 layers.
# Measured 0.01412 on an H100 80GB HBM3 at 700 W (random flagship
# weights, batch 64); the bound leaves about 3x margin
INT8_ENGINE_REL_L2 = 0.04
# the W8A8 forward against the plain bf16 forward: the gate of the JAX
# package's int8 test (tests/test_fused_int8.py)
INT8_COSINE = 0.995


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 50) -> float:
    """Host time per call of `fn` (the wrapper's checks, tensor maps and
    launch), the device's queue left to drain afterwards."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def bound(nbytes, flops, peak):
    """(least ms, "bytes" or "operations") for moving `nbytes` and doing
    `flops` at `peak` operations per second."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_env():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke runs "
                           "on a CUDA GPU only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"devices {torch.cuda.device_count()} | matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from transformer_latent_diffusion_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    secs = time.perf_counter() - t0
    log(f"[build] {path} in {secs:.1f} s")
    name = "?"
    for line in (path.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Performance Loss" in line:  # names its function itself
            log(f"[build]   {line.split('function', 1)[-1].strip()}: "
                f"{line.split(':', 1)[1].split(' in the function')[0].strip()}")
        elif "registers" in line:
            log(f"[build]   {name}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            log(f"[build]   {name}: {line.strip()}")


def _ptxas_report(tag, fragments):
    """Registers and spills that ptxas reported for the kernels whose names
    hold one of `fragments`, and whether it serialised their `wgmma`s
    (build.log's C7515 / C7520 lines); a spill or a serialised `wgmma`
    raises."""
    from transformer_latent_diffusion_tpu_torch.ops import _build

    name, found, serial = "?", {}, set()
    for line in (_build.library_path().parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Performance Loss" in line:
            serial.add(line.split("function '")[-1].rstrip("'"))
        elif not any(f in name for f in fragments):
            continue
        elif "spill stores" in line:
            found.setdefault(name, {})["spills"] = line.strip()
        elif "registers" in line:
            found.setdefault(name, {})["registers"] = line.split("Used")[1].split(",")[0].strip()
    for fn, info in sorted(found.items()):
        frag = next(f for f in fragments if f in fn)
        start = fn.index(frag)
        end = fn.find("Ev", start)  # the template arguments end before the void return type
        short = fn[start:end if end > start else start + len(frag) + 6]
        log(f"[{tag}] ptxas {short}: {info.get('registers')} at launch, {info.get('spills')}")
    serialised = [f for f in serial if any(x in f for x in fragments)]
    log(f"[{tag}] ptxas serialised the wgmma of: {serialised or 'none of them'} (C7515/C7520)")
    if not found or any("0 bytes spill stores, 0 bytes spill loads" not in i.get("spills", "")
                        for i in found.values()):
        raise AssertionError(f"{fragments}: missing from build.log, or spilling")
    if serialised:
        raise AssertionError(f"ptxas serialised the wgmma of {serialised}")


def _errors(out, ref):
    scale = float(ref.abs().max())
    err = float((out.float() - ref.float()).abs().max())
    return rel_l2(out.float(), ref.float()), err, err / max(scale, 1e-30)


def dw_equal_work(h, dw, dwb, hw, out_dtype=torch.bfloat16):
    """The same work as `dwconv_gelu` in PyTorch calls: the depthwise 3x3
    convolution with its bias (`F.conv2d`, groups = C, on the channels-last
    rows as stored), then `F.gelu` (exact erf), in h's dtype, cast to
    `out_dtype` where that differs. The weights' re-layout is done once,
    outside the timed call."""
    F = torch.nn.functional
    c = h.shape[1]
    grid = h.view(-1, hw, hw, c).permute(0, 3, 1, 2)  # NCHW view, channels-last strides
    w = dw.t().reshape(c, 1, 3, 3).to(h.dtype).contiguous(memory_format=torch.channels_last)
    bias = dwb.reshape(-1).to(h.dtype)

    def run():
        y = F.gelu(F.conv2d(grid, w, bias, padding=1, groups=c))
        return y if y.dtype == out_dtype else y.to(out_dtype)
    return run


def dwb_equal_work(da, h, dw, dwb, hw):
    """The same work as `dwconv_gelu_bwd` in PyTorch calls: autograd's
    backward alone through the depthwise convolution (groups = C, with
    bias) and F.gelu in float32 on the channels-last rows as stored, the
    forward run once beforehand, untimed."""
    F = torch.nn.functional
    ch = h.shape[1]
    hg = h.detach().view(-1, hw, hw, ch).permute(0, 3, 1, 2).requires_grad_(True)
    wg = dw.float().t().reshape(ch, 1, 3, 3).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    bg = dwb.detach().clone().requires_grad_(True)
    out = F.gelu(F.conv2d(hg, wg, bg, padding=1, groups=ch))
    dag = da.view(-1, hw, hw, ch).permute(0, 3, 1, 2)
    return lambda: torch.autograd.grad(out, (hg, wg, bg), dag, retain_graph=True)


def _sepconv_calls(x, w1, b1, wdw, dwb, w2, b2, hw, lnw=None):
    """(LN,) expand, depthwise 3x3 + bias, GELU, contract (+ x): the
    sep-conv MLP in PyTorch calls, in x's dtype, on the token rows."""
    F = torch.nn.functional
    b, n, d = x.shape
    c = w1.shape[0]
    h = x if lnw is None else F.layer_norm(x, (d,), *lnw)
    h = F.linear(h, w1, b1).view(b, hw, hw, c).permute(0, 3, 1, 2)
    a = F.gelu(F.conv2d(h, wdw, dwb, padding=1, groups=c))
    y = F.linear(a.permute(0, 2, 3, 1).reshape(b, n, c), w2, b2)
    return y if lnw is None else x + y


def _dw_weight(dw):
    c = dw.shape[1]
    return dw.t().reshape(c, 1, 3, 3).contiguous(memory_format=torch.channels_last)


def sepconv_equal_work(x, w1, b1, dw, dwb, w2, b2, hw, ln=None):
    """The same work as K5's forward (ln None) or K9 (LN3 first, the
    residual after) in PyTorch calls: (F.layer_norm,) F.linear, F.conv2d
    groups=C with bias, F.gelu, F.linear (, + x), all in x's dtype."""
    dt = x.dtype
    args = (w1, b1.reshape(-1).to(dt), _dw_weight(dw), dwb.reshape(-1).to(dt), w2,
            b2.reshape(-1).to(dt), hw)
    lnw = None if ln is None else tuple(t.reshape(-1).to(dt) for t in ln)
    return lambda: _sepconv_calls(x, *args, lnw=lnw)


def sepconv_bwd_equal_work(x, g, w1, b1, dw, dwb, w2, hw):
    """The same work as K5's backward in PyTorch calls: autograd's backward
    alone through `sepconv_equal_work`'s calls to x and the six weights and
    biases (the forward run once beforehand, untimed: the kernel recomputes
    h and c besides)."""
    dt = x.dtype
    leaves = [t.detach().clone().requires_grad_(True) for t in (
        x, w1, b1.reshape(-1).to(dt), _dw_weight(dw), dwb.reshape(-1).to(dt), w2,
        torch.zeros(w2.shape[0], device=x.device, dtype=dt))]
    out = _sepconv_calls(*leaves, hw)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def pair_equal_work(x, ln1s, ln1b, wqkv, ln2s, ln2b, wq, k_cond, v_cond, heads):
    """The same work as K8 in PyTorch calls: x + SDPA(F.linear(F.layer_norm
    x)), then + SDPA of F.linear(F.layer_norm) against the given cond K/V,
    in x's dtype."""
    F = torch.nn.functional
    b, n, d = x.shape
    dt = x.dtype
    ln1 = tuple(t.reshape(-1).to(dt) for t in (ln1s, ln1b))
    ln2 = tuple(t.reshape(-1).to(dt) for t in (ln2s, ln2b))

    def split(t):
        return t.reshape(b, -1, heads, d // heads).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(b, n, d)

    def run():
        q, k, v = F.linear(F.layer_norm(x, (d,), *ln1), wqkv).chunk(3, dim=-1)
        x1 = x + merge(F.scaled_dot_product_attention(split(q), split(k), split(v)))
        qc = F.linear(F.layer_norm(x1, (d,), *ln2), wq)
        return x1 + merge(F.scaled_dot_product_attention(split(qc), split(k_cond),
                                                         split(v_cond)))
    return run


def int8_layer_equal_work(tokens, cond, layer, hw, heads):
    """The same work as one W8A8 layer (K7) in PyTorch calls: the layer of
    `ops/fused_stack_int8.py` with each stage a PyTorch composition:
    F.layer_norm + |max| + scale + round for rowquant, `torch._int_mm` and
    the scales for gemm_i8, F.linear for the cond K/V, SDPA for the two
    attentions, F.conv2d + F.gelu for the depthwise stage."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack_int8 as q8
    from transformer_latent_diffusion_tpu_torch.scripts.microbench_int8 import (
        int_mm_equal_work,
        quant_equal_work,
    )

    F = torch.nn.functional

    def quant(x, ln=None):
        if ln is not None:
            x = F.layer_norm(x, (x.shape[1],), ln[0].reshape(-1), ln[1].reshape(-1), 1e-5)
        return quant_equal_work(x)

    def gemm(a, w):
        return F.linear(a, w)

    def attend(q, kv_rows, residual, n_q, n_kv):
        d = q.shape[1]
        b = q.shape[0] // n_q

        def split(t, n):
            return t.reshape(b, n, heads, d // heads).transpose(1, 2)

        k, v = kv_rows.chunk(2, dim=-1)
        o = F.scaled_dot_product_attention(split(q, n_q), split(k, n_kv), split(v, n_kv))
        return residual + o.transpose(1, 2).reshape(b * n_q, d).float()

    def sa(qkv, residual, n_heads, n):
        q, kv = qkv.split([qkv.shape[1] // 3, 2 * qkv.shape[1] // 3], dim=-1)
        return attend(q, kv, residual, n, n)

    def ca(qc, kv, residual, ln, n_heads, n):
        return attend(qc, kv, residual, n, 2), None

    def dwg(h, dw, dwb, hw_, out_dtype=None):
        y = dw_equal_work(h, dw, dwb, hw_, out_dtype or torch.bfloat16)()  # NCHW view
        return y.permute(0, 2, 3, 1).reshape(h.shape)

    ops = (quant, int_mm_equal_work, gemm, sa, ca, dwg)
    return lambda: q8._layer_stack_int8(tokens, cond, layer, hw, heads, ops)


def _bit_equal_twice(name, fn, tag):
    """Two launches of `fn` on the same inputs give the same bits."""
    a, b = _tuple(fn()), _tuple(fn())
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    log(f"[{tag}] {name}: two launches bit-equal")


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

    dev = torch.device(DEVICE)
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * std).to(dev, dtype)

    m = B * N
    x = randn(m, D)
    ln = (1.0 + randn(D, std=0.1), randn(D, std=0.1))
    wqkv = randn(3 * D, D, std=D ** -0.5, dtype=torch.bfloat16)
    w1 = randn(HIDDEN, D, std=D ** -0.5, dtype=torch.bfloat16)
    b1 = randn(HIDDEN, std=0.1)
    wq = randn(D, D, std=D ** -0.5, dtype=torch.bfloat16)
    wkv = randn(2 * D, D, std=D ** -0.5, dtype=torch.bfloat16)
    w2 = randn(D, HIDDEN, std=HIDDEN ** -0.5, dtype=torch.bfloat16)
    b2 = randn(D, std=0.1)
    act = randn(m, HIDDEN, dtype=torch.bfloat16)
    xn = randn(m, D, dtype=torch.bfloat16)  # LN3 rows, as cross_attention writes them
    cond = randn(2 * B, D, dtype=torch.bfloat16)
    qkv = randn(m, 3 * D, dtype=torch.bfloat16)
    qc = randn(m, D, dtype=torch.bfloat16)
    kv = randn(2 * B, 2 * D, dtype=torch.bfloat16)
    hmat = randn(m, HIDDEN, dtype=torch.bfloat16)
    dw = randn(9, HIDDEN, std=1 / 3, dtype=torch.bfloat16)
    dwb = randn(HIDDEN, std=0.1)

    gemm_cases = [  # (name, kernel call, plain call); residual cases compare x' - x
        ("qkv", lambda: fs.ln_gemm(x, wqkv, ln=ln),
         lambda: fs.ln_gemm_plain(x, wqkv, ln=ln)),
        ("q", lambda: fs.ln_gemm(x, wq, ln=ln),
         lambda: fs.ln_gemm_plain(x, wq, ln=ln)),
        ("kv", lambda: fs.ln_gemm(cond, wkv), lambda: fs.ln_gemm_plain(cond, wkv)),
        ("kv_ragged", lambda: fs.ln_gemm(cond[:4].contiguous(), wkv),
         lambda: fs.ln_gemm_plain(cond[:4], wkv)),
        ("expand", lambda: fs.ln_gemm(xn, w1, bias=b1),
         lambda: fs.ln_gemm_plain(xn, w1, bias=b1)),
        ("contract", lambda: fs.ln_gemm(act, w2, bias=b2, residual=x.clone()) - x,
         lambda: fs.ln_gemm_plain(act, w2, bias=b2, residual=x) - x),
    ]
    results = {}
    worst = {}
    for name, kern, plain in gemm_cases:
        r, a, rel_a = _errors(kern(), plain())
        log(f"[kernels] ln_gemm/{name}: rel-L2 {r:.2e} max-abs {a:.3e} "
            f"({rel_a:.2e} of max |ref|)")
        if not (r < KERNEL_REL_L2 and rel_a < KERNEL_MAX_ABS):
            raise AssertionError(f"ln_gemm/{name} disagrees with its plain version")
        worst["ln_gemm"] = max(worst.get("ln_gemm", 0.0), a)
    # each product alone, then the five of one layer together
    xr = x.clone()
    flops = {"qkv": (m, 3 * D, D), "q": (m, D, D), "kv": (2 * B, 2 * D, D),
             "expand": (m, HIDDEN, D), "contract": (m, D, HIDDEN)}
    alone = {"qkv": lambda: fs.ln_gemm(x, wqkv, ln=ln),
             "q": lambda: fs.ln_gemm(x, wq, ln=ln),
             "kv": lambda: fs.ln_gemm(cond, wkv),
             "expand": lambda: fs.ln_gemm(xn, w1, bias=b1),
             "contract": lambda: fs.ln_gemm(act, w2, bias=b2, residual=xr)}
    F = torch.nn.functional
    bf = torch.bfloat16
    xb = x.to(bf)
    linear = {"qkv": lambda: F.linear(xb, wqkv), "q": lambda: F.linear(xb, wq),
              "kv": lambda: F.linear(cond, wkv), "expand": lambda: F.linear(xn, w1, b1.to(bf)),
              "contract": lambda: F.linear(act, w2, b2.to(bf))}
    for name, fn in alone.items():
        ms = time_ms(fn)
        lin = time_ms(linear[name])
        mm, nn, kk = flops[name]
        log(f"[kernels] ln_gemm/{name} ({mm}x{nn}x{kk}): {ms:.4f} ms, "
            f"{2 * mm * nn * kk / ms / 1e9:.1f} TFLOP/s; F.linear {lin:.4f} ms")
    # one writer per output element: two launches of each product bit-equal
    for name, fn in alone.items():
        twice = ([fs.ln_gemm(act, w2, bias=b2, residual=x.clone()) for _ in range(2)]
                 if name == "contract" else [fn(), fn()])
        if not torch.equal(*twice):
            raise AssertionError(f"ln_gemm/{name}: two launches on the same inputs differ")
    del twice
    log(f"[kernels] ln_gemm: two launches bit-equal for all five products; host time per "
        f"call {host_ms(alone['qkv']):.4f} ms (LayerNorm), "
        f"{host_ms(alone['expand']):.4f} ms (streaming)")
    layer_gemm = lambda: (fs.ln_gemm(x, wqkv, ln=ln), fs.ln_gemm(x, wq, ln=ln),  # noqa: E731
                          fs.ln_gemm(cond, wkv), fs.ln_gemm(xn, w1, bias=b1),
                          fs.ln_gemm(act, w2, bias=b2, residual=xr))
    layer_gemm_plain = lambda: (  # noqa: E731
        fs.ln_gemm_plain(x, wqkv, ln=ln), fs.ln_gemm_plain(x, wq, ln=ln),
        fs.ln_gemm_plain(cond, wkv), fs.ln_gemm_plain(xn, w1, bias=b1),
        fs.ln_gemm_plain(act, w2, bias=b2, residual=x))
    results["ln_gemm"] = (layer_gemm, layer_gemm_plain)

    def updates(outs):
        return torch.cat([(outs[0] - x).flatten(), outs[1].float().flatten()])

    cases = {
        "self_attention": (
            lambda: fs.self_attention(qkv, x.clone(), HEADS, N) - x,
            lambda: fs.self_attention_plain(qkv, x, HEADS, N) - x,
            lambda: fs.self_attention(qkv, xr, HEADS, N),
            lambda: fs.self_attention_plain(qkv, x, HEADS, N)),
        # both outputs: the residual's update and the LN3 rows
        "cross_attention": (
            lambda: updates(fs.cross_attention(qc, kv, x.clone(), ln, HEADS, N)),
            lambda: updates(fs.cross_attention_plain(qc, kv, x, ln, HEADS, N)),
            lambda: fs.cross_attention(qc, kv, xr, ln, HEADS, N),
            lambda: fs.cross_attention_plain(qc, kv, x, ln, HEADS, N)),
        "dwconv_gelu": (
            lambda: fs.dwconv_gelu(hmat, dw, dwb, HW),
            lambda: fs.dwconv_gelu_plain(hmat, dw, dwb, HW),
            lambda: fs.dwconv_gelu(hmat, dw, dwb, HW),
            lambda: fs.dwconv_gelu_plain(hmat, dw, dwb, HW)),
    }
    # one whole layer: the four kernels against the plain stack
    params = {f"denoiser_trans_block.decoder_blocks.0.{k}": v for k, v in {
        "norm1.weight": ln[0], "norm1.bias": ln[1], "norm2.weight": ln[0],
        "norm2.bias": ln[1], "norm3.weight": ln[0], "norm3.bias": ln[1],
        "self_attention.qkv_linear.weight": wqkv, "cross_attention.q_linear.weight": wq,
        "cross_attention.kv_linear.weight": wkv, "mlp.mlp.0.weight": w1[:, :, None, None],
        "mlp.mlp.0.bias": b1, "mlp.mlp.1.weight": dw.T.reshape(HIDDEN, 1, 3, 3),
        "mlp.mlp.1.bias": dwb, "mlp.mlp.3.weight": w2[:, :, None, None],
        "mlp.mlp.3.bias": b2}.items()}
    stack = fs.pack_layer_stack(params, [0], torch.bfloat16)
    xb = x.reshape(B, N, D).to(torch.bfloat16)
    cb = cond.reshape(B, 2, D)
    got = fs.fused_layer_stack(xb, cb, stack, HW, HEADS).float() - xb.float()
    want = fs.fused_layer_stack_plain(xb, cb, stack, HW, HEADS).float() - xb.float()
    r = rel_l2(got, want)
    log(f"[kernels] one decoder layer, kernels vs fused_layer_stack_plain: rel-L2 of the "
        f"layer's update {r:.2e} (bound {LAYER_REL_L2})")
    if not r < LAYER_REL_L2:
        raise AssertionError("the kernels' decoder layer disagrees with the plain stack")

    for name, (kern, plain, kern_t, plain_t) in cases.items():
        r, a, rel_a = _errors(kern(), plain())
        log(f"[kernels] {name}: rel-L2 {r:.2e} max-abs {a:.3e} "
            f"({rel_a:.2e} of max |ref|)")
        if not (r < KERNEL_REL_L2 and rel_a < KERNEL_MAX_ABS):
            raise AssertionError(f"{name} disagrees with its plain version")
        worst[name] = a
        results[name] = (kern_t, plain_t)
    torch.cuda.synchronize()
    # the TMA reduce-add gives each residual element one writer: two
    # launches on the same inputs are bit-equal
    twice = [x.clone(), x.clone()]
    for t in twice:
        fs.self_attention(qkv, t, HEADS, N)
    if not torch.equal(*twice):
        raise AssertionError("self_attention: two launches on the same inputs differ")
    log(f"[kernels] self_attention: two launches bit-equal; host time per call "
        f"{host_ms(lambda: fs.self_attention(qkv, xr, HEADS, N)):.4f} ms")
    del twice

    timing = time_against_plain(results, "kernels")

    # one PyTorch call per launch for the same products / attention (the
    # fused LayerNorm prologues and residual epilogues not included)
    heads = qkv.reshape(B, N, 3, HEADS, 64).permute(2, 0, 3, 1, 4).contiguous()
    qh = qc.reshape(B, N, HEADS, 64).transpose(1, 2).contiguous()
    kvh = kv.reshape(B, 2, 2, HEADS, 64).permute(2, 0, 3, 1, 4).contiguous()
    library = {
        "ln_gemm": lambda: (F.linear(xb, wqkv), F.linear(xb, wq), F.linear(cond, wkv),
                            F.linear(xn, w1, b1.to(bf)), F.linear(act, w2, b2.to(bf))),
        "self_attention": lambda: F.scaled_dot_product_attention(heads[0], heads[1], heads[2]),
        "cross_attention": lambda: F.scaled_dot_product_attention(qh, kvh[0], kvh[1]),
    }
    library = {k: time_ms(fn) for k, fn in library.items()}
    library["dwconv_gelu"] = None  # no one call: a depthwise conv, then a GELU
    for name, ms in library.items():
        log(f"[kernels] {name}: library call {ms if ms is None else f'{ms:.4f}'} ms")
    # dwconv_gelu on its TMA body: two launches bit-equal, the equal-work
    # yardstick (F.conv2d, groups = C, with bias, then F.gelu), ptxas
    _bit_equal_twice("dwconv_gelu", lambda: fs.dwconv_gelu(hmat, dw, dwb, HW), "kernels")
    eq_dw = time_ms(dw_equal_work(hmat, dw, dwb, HW))
    library["dwconv_gelu (equal work)"] = eq_dw
    ms = timing["dwconv_gelu"][0]
    log(f"[kernels] dwconv_gelu: {ms:.4f} ms; equal-work yardstick (F.conv2d groups=C with "
        f"bias + F.gelu, bf16) {eq_dw:.4f} ms: the kernel is "
        f"{'no slower' if ms <= eq_dw else f'{ms / eq_dw:.2f}x slower'}")
    _ptxas_report("kernels", ("dwconv_gelu_kernel",))
    # the same work as self_attention: SDPA, then its output added into the
    # float32 residual in place (SDPA alone writes bf16 and reads no residual)
    xv = xr.view(B, N, HEADS, 64)
    eq = time_ms(lambda: xv.add_(F.scaled_dot_product_attention(
        heads[0], heads[1], heads[2]).transpose(1, 2)))
    library["self_attention (equal work)"] = eq
    # the same work as the five products: F.layer_norm + F.linear for qkv
    # and q (the bf16 rounding of the normalised rows between them),
    # F.linear for kv and expand, and contract's F.linear output added into
    # the float32 residual in place (torch.addmm takes one dtype for all
    # three operands, so it cannot add bf16 products into float32)
    def equal_work():
        for w_ in (wqkv, wq):
            F.linear(F.layer_norm(x, (D,), ln[0], ln[1], 1e-5).to(bf), w_)
        F.linear(cond, wkv)
        F.linear(xn, w1, b1.to(bf))
        xr.add_(F.linear(act, w2, b2.to(bf)))

    eq_gemm = time_ms(equal_work)
    library["ln_gemm (equal work)"] = eq_gemm
    ms = timing["ln_gemm"][0]
    log(f"[kernels] ln_gemm: {ms:.4f} ms for the five products; equal-work yardstick "
        f"(F.layer_norm + F.linear, F.linear, the add into the float32 residual) "
        f"{eq_gemm:.4f} ms: the kernel is "
        f"{'no slower' if ms <= eq_gemm else f'{ms / eq_gemm:.2f}x slower'}; F.linear alone "
        f"{library['ln_gemm']:.4f} ms")
    ms = timing["self_attention"][0]
    log(f"[kernels] self_attention: {ms:.4f} ms; equal-work yardstick (SDPA + the add into "
        f"the float32 residual) {eq:.4f} ms: the kernel is "
        f"{'no slower' if ms <= eq else f'{ms / eq:.2f}x slower'}")
    # the same work as cross_attention: SDPA against the 2 conditioning keys,
    # its output added into the float32 residual in place, and the LN3 rows
    # (F.layer_norm of the updated residual) written in bf16

    def cross_equal_work():
        xv.add_(F.scaled_dot_product_attention(qh, kvh[0], kvh[1]).transpose(1, 2))
        F.layer_norm(xr, (D,), ln[0], ln[1], 1e-5).to(bf)

    eq_ca = time_ms(cross_equal_work)
    library["cross_attention (equal work)"] = eq_ca
    ms = timing["cross_attention"][0]
    log(f"[kernels] cross_attention: {ms:.4f} ms; equal-work yardstick (SDPA + the add into "
        f"the float32 residual + F.layer_norm to bf16 rows) {eq_ca:.4f} ms: the kernel is "
        f"{'no slower' if ms <= eq_ca else f'{ms / eq_ca:.2f}x slower'}; SDPA alone "
        f"{library['cross_attention']:.4f} ms")
    return worst, timing, library


def time_against_plain(results, tag):
    """{name: (kernel ms, plain ms)}, each the mean of two timings taken
    plain, kernel, kernel, plain."""
    timing = {}
    for name, (kern, plain) in results.items():
        p1 = time_ms(plain)
        k1 = time_ms(kern)
        k2 = time_ms(kern)
        p2 = time_ms(plain)
        timing[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"[{tag}] {name}: {timing[name][0]:.4f} ms per layer, plain "
            f"{timing[name][1]:.4f} ms (kernel runs {k1:.4f}/{k2:.4f}, plain "
            f"{p1:.4f}/{p2:.4f})")
    return timing


def k1_bounds():
    """Least ms per decoder layer of each K1 kernel at the main path's
    shapes (each input read once, each output written once)."""
    m = B * N
    gemms = [  # (rows, N, K, A bytes per element, out bytes, extra bytes)
        (m, 3 * D, D, 4, 2, 0), (m, D, D, 4, 2, 0), (2 * B, 2 * D, D, 2, 2, 0),
        (m, HIDDEN, D, 2, 2, HIDDEN * 4), (m, D, HIDDEN, 2, 0, m * D * 8 + D * 4)]
    gbytes = sum(r * k * ab + n * k * 2 + r * n * ob + ex for r, n, k, ab, ob, ex in gemms)
    gflops = sum(2 * r * n * k for r, n, k, *_ in gemms)
    return {
        "ln_gemm": bound(gbytes, gflops, BF16_TENSOR_FLOP_S),
        "self_attention": bound(m * 3 * D * 2 + m * D * 8,
                                4 * B * HEADS * N * N * 64, BF16_TENSOR_FLOP_S),
        "cross_attention": bound(m * D * 2 + 2 * B * 2 * D * 2 + m * D * 8 + m * D * 2,
                                 16 * m * D, F32_FLOP_S),
        "dwconv_gelu": bound(m * HIDDEN * 4 + 9 * HIDDEN * 2 + HIDDEN * 4,
                             26 * m * HIDDEN, F32_FLOP_S),
    }


def flagship_configs():
    from transformer_latent_diffusion_tpu_torch.configs import (
        ClipConfig,
        DenoiserConfig,
        DenoiserLoad,
        LTDConfig,
        VaeConfig,
    )

    den = DenoiserConfig(image_size=32, noise_embed_dims=256, patch_size=2,
                         embed_dim=768, dropout=0, n_layers=12)
    return LTDConfig(denoiser_cfg=den, denoiser_load=DenoiserLoad(dtype="bfloat16"),
                     vae_cfg=VaeConfig(), clip_cfg=ClipConfig())


def phase_engine(cfg):
    """One fused-engine forward vs the plain bf16 Denoiser forward."""
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import (
        make_fused_apply,
    )
    from transformer_latent_diffusion_tpu_torch.utils.common import (
        init_random_weights_,
    )

    dev = torch.device(DEVICE)
    model = Denoiser.from_config(cfg.denoiser_cfg, dtype=torch.bfloat16)
    init_random_weights_(model, 0)
    model.to(dev).eval()
    g = torch.Generator(device="cpu").manual_seed(1)
    size = cfg.denoiser_cfg.image_size
    x = torch.randn(B, 4, size, size, generator=g).to(dev)
    noise = torch.full((B, 1), 0.5, device=dev)
    label = torch.randn(B, cfg.denoiser_cfg.text_emb_size, generator=g).to(dev)
    engine = make_fused_apply(cfg.denoiser_cfg, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        prepared = engine.prepare(model.state_dict())
        out = engine.apply_prepared(prepared, x, noise, label)
        ref = model(x, noise, label)
    torch.cuda.synchronize()
    r = rel_l2(out, ref)
    cos = float(torch.nn.functional.cosine_similarity(
        out.double().flatten(), ref.double().flatten(), dim=0))
    log(f"[engine] fused engine vs plain bf16 forward, batch {B}: rel-L2 {r:.5f} "
        f"(bound {ENGINE_REL_L2}), cos {cos:.6f}")
    if not (torch.isfinite(out).all() and r < ENGINE_REL_L2):
        raise AssertionError("fused engine disagrees with the plain forward")
    with torch.no_grad():
        t_eng = time_ms(lambda: engine.apply_prepared(prepared, x, noise, label), 5, 2)
        t_ref = time_ms(lambda: model(x, noise, label), 5, 2)
    log(f"[engine] one forward at batch {B}: fused {t_eng:.3f} ms, plain bf16 "
        f"{t_ref:.3f} ms")
    del model, prepared


def phase_library(cfg, per_layer=None, tag="library"):
    """The library entry point: a warm-up run, then N_IMGS x N_ITER DDIM
    steps (CFG 6) with exact launch counts (`per_layer` per decoder layer
    and call, K1's by default). Returns (transformer, launches, images/s)."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
    from transformer_latent_diffusion_tpu_torch.sampling import DiffusionTransformer

    per_layer = per_layer or fs.LAUNCHES_PER_LAYER
    t0 = time.perf_counter()
    tr = DiffusionTransformer(cfg, device=DEVICE, seed=0)
    torch.cuda.synchronize()
    log(f"[{tag}] DiffusionTransformer built in {time.perf_counter() - t0:.1f} s")
    latents = []
    tr.vae.post_quant_conv.register_forward_pre_hook(
        lambda mod, args: latents.append(args[0].detach()))

    def run():
        return tr.generate_array_from_text("a cute cat", num_imgs=N_IMGS,
                                           n_iter=N_ITER, sampler="ddim",
                                           class_guidance=6)

    # warm-up: the loop's first call runs eagerly, the second captures it
    (_, warm), ((_, capture), held) = _host_s(run), _held_gib(lambda: _host_s(run))
    latents.clear()
    _reset_counts()
    t0 = time.perf_counter()
    imgs = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    px = 8 * cfg.denoiser_cfg.image_size
    if imgs.shape != (N_IMGS, px, px, 3) or imgs.dtype.name != "uint8":
        raise AssertionError(f"images {imgs.shape} {imgs.dtype}")
    if len(latents) != 1 or not torch.isfinite(latents[0]).all():
        raise AssertionError("decoded latents missing or not finite")
    if float(imgs.std()) <= 0:
        raise AssertionError("images are constant")
    calls = N_ITER  # n_iter - 1 update steps + the final denoise
    expect = _expect({k: v * cfg.denoiser_cfg.n_layers * calls
                      for k, v in per_layer.items()})
    log(f"[{tag}] generate_array_from_text {N_IMGS} imgs x {N_ITER} DDIM steps: "
        f"{wall:.3f} s ({N_IMGS / wall:.3f} imgs/s; warm-up runs: the first {warm:.3f} s, "
        f"eager, the second {capture:.3f} s, the loop's capture, which holds {held:.3f} GiB); "
        f"launches { {k: v for k, v in launches.items() if v} } (expected "
        f"{ {k: v for k, v in expect.items() if v} }, no other kernel)")
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != expected {expect}")
    return tr, launches, N_IMGS / wall


@contextlib.contextmanager
def _wsgi_server(service):
    """The service's WSGI app on a local socket, one thread per request as
    `serve.app.serve` runs it; yields request(path, body=None, token=...)
    -> (status, body bytes), the reply's headers left in
    `request.headers`. Stops the server."""
    from socketserver import ThreadingMixIn
    from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

    class ThreadingServer(ThreadingMixIn, WSGIServer):
        daemon_threads = True

    from transformer_latent_diffusion_tpu_torch.serve.app import create_wsgi_app

    class QuietHandler(WSGIRequestHandler):
        def log_message(self, *args):
            pass

    os.environ["API_TOKEN"] = "smoke-token"
    app = create_wsgi_app(service=service)
    server = make_server("127.0.0.1", 0, app, server_class=ThreadingServer,
                         handler_class=QuietHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"

    def request(path, body=None, token="smoke-token"):
        headers = {"Content-Type": "application/json"}
        if token:
            headers["Authorization"] = f"Bearer {token}"
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(base + path, data=data, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                request.headers = dict(resp.headers)
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            request.headers = dict(e.headers)
            return e.code, e.read()

    try:
        yield request
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def phase_serving(service, tag="serving"):
    """The WSGI service on a real socket: GET /, 3 x POST /generate-image/
    at the defaults (JPEGs of the model's size), a 401, /healthz."""
    import io

    from PIL import Image

    px = 8 * service.transformer.cfg.denoiser_cfg.image_size
    with _wsgi_server(service) as request:
        status, _ = request("/")
        if status != 200:
            raise AssertionError(f"GET / -> {status}")
        times = []
        for i in range(3):
            t0 = time.perf_counter()
            status, body = request("/generate-image/", {"prompt": f"a cute cat {i}"})
            times.append(time.perf_counter() - t0)
            if status != 200 or not body.startswith(b"\xff\xd8\xff"):
                raise AssertionError(f"POST /generate-image/ -> {status} {body[:200]!r}")
            size = Image.open(io.BytesIO(body)).size
            if size != (px + 8, px + 8):  # one image, a 4-pixel border
                raise AssertionError(f"JPEG of {size}, expected {px + 8} px a side")
        status, _ = request("/generate-image/", {"prompt": "x"}, token=None)
        if status != 401:
            raise AssertionError(f"POST without a token -> {status}, expected 401")
        status, body = request("/healthz")
        health = json.loads(body)
        if status != 200 or health["requests"] != 3 or health["errors"] != 0:
            raise AssertionError(f"/healthz -> {status} {health}")
        log(f"[{tag}] GET / 200; 3 x POST /generate-image/ (defaults: 1 image, "
            f"15-step DPM++) 200 JPEG of {px} px in "
            f"{', '.join(f'{t:.3f}' for t in times)} s; no token 401; /healthz "
            f"{health['requests']} requests on {health['device_kind']}")


def phase_resized_grid(tr):
    """The 256 px flagship sampled on a 32 x 32-token grid (generate with
    img_size=64): the positional table resized once, the Denoiser's linen
    path (flash attention; the MLP plain, as the JAX gates have it for a
    native 16 x 16 grid), not the fused engine."""
    den = tr.cfg.denoiser_cfg
    labels = tr.clip_model.encode_text(["a cute cat"] * 4)

    def run():
        return tr.diffuser.generate(labels, n_iter=RESIZE_ITER, num_imgs=4,
                                    img_size=2 * den.image_size, class_guidance=6,
                                    sampler="ddim", output="uint8", sharp_f=0,
                                    bright_f=0, scale_factor=tr._scale_factor)

    run()  # the loop of this grid: its first call runs eagerly,
    run()  # the second captures it
    _reset_counts()
    t0 = time.perf_counter()
    img, x0 = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    expect = _expect({"flash_attention": den.n_layers * RESIZE_ITER})
    px = 16 * den.image_size
    log(f"[resized-grid] 256 px model, generate(img_size={2 * den.image_size}): "
        f"4 images x {RESIZE_ITER} DDIM steps in {wall:.3f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} } (expected only "
        f"flash_attention {expect['flash_attention']})")
    if img.shape != (4, px, px, 3) or not torch.isfinite(x0).all():
        raise AssertionError(f"resized-grid images {tuple(img.shape)}")
    if launches != expect:
        raise AssertionError(f"resized-grid launches {launches} != {expect}")


# ------------------------------ the sampler's CUDA graph ------------------------------

# [sampler-graph] on the int8 engine and the 512 px linen path: a small
# batch and few steps (the 256 px bf16 engine runs the library workload)
GRAPH_BRIEF_IMGS, GRAPH_BRIEF_ITER = 4, 8
# [sampler-extras]: each option at 8 images x 10 steps through the graph,
# bit-equal to the same loop run eagerly, in which every denoiser call is
# held against the plain bf16 Denoiser's call on the same inputs (for
# block caching: the engine with the plain stack, the same delta) within
# the engine's bound for one forward (ENGINE_REL_L2)
EXTRA_IMGS, EXTRA_ITER = 8, 10
# [graph-keys]: the HTTP default request's loop (1 image, 15 DPM++ steps),
# its first calls and a mix of keys cycling in turn, more keys (n_iter
# 11, 12, ...) than the generator keeps
KEYS_ITER, KEYS_MIX = 15, 10


def _loop_calls(spec):
    """Denoiser calls of one run of a step loop (no block caching)."""
    per_step = 2 if spec.step == "heun" else 1
    return per_step * spec.n_steps + 1


def _plan(tr, prompt, seed, n_imgs, n_iter, gen=None, **kw):
    """The plan of generate_array_from_text's sampler call for `prompt`
    (on tr's generator unless `gen` is given)."""
    labels, _ = tr._encode_prompts([prompt] * n_imgs, None, n_imgs)
    kw.setdefault("sampler", "ddim")
    return (gen or tr.diffuser).plan_loop(labels, num_imgs=n_imgs, n_iter=n_iter, seed=seed,
                                          img_size=tr.diffuser.model.image_size,
                                          class_guidance=6, exponent=1,
                                          schedule_shift=tr.schedule_shift, **kw)


def _host_s(fn):
    """Seconds of fn() on the host clock, the device's queue drained."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _held_gib(fn):
    """fn()'s result and the GiB of device memory it left reserved, the
    caching allocator's free blocks released before and after (for a call
    that captures a loop: the graph's pool, static inputs and output)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    out = fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out, (torch.cuda.memory_reserved() - before) / 2 ** 30


def phase_sampler_graph(tr, per_layer, tag, n_imgs, n_iter):
    """The sampler's step loop through its CUDA graph against the same
    loop run eagerly (`SamplePlan.run_eager`) on the same inputs:
    bit-equal latents, the exact launch counts through a replay, one
    capture for two calls with other prompts and seeds, the graph's and
    the eager loop's times, and after `load_state_dict` with other weights
    an eager first call and a new capture at the second, both the new
    weights' eager result, with the device memory the capture holds."""
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.utils.common import init_random_weights_

    gen = tr.diffuser
    n_layers = tr.cfg.denoiser_cfg.n_layers
    calls = [("a cute cat", 11), ("a red car on a road at night", 23)]
    for _ in range(2):  # the key's eager first call and its capture, at the latest
        gen.run_plan(_plan(tr, *calls[0], n_imgs, n_iter))
    captures = gen.graphs.captures
    first = None
    for prompt, seed in calls:
        plan = _plan(tr, prompt, seed, n_imgs, n_iter)
        eager = plan.run_eager()
        _reset_counts()
        got = gen.run_plan(plan)
        launches = _counts()
        expect = _expect({k: v * n_layers * _loop_calls(plan.spec)
                          for k, v in per_layer.items()})
        same = torch.equal(got, eager)
        log(f"[{tag}] {n_imgs} imgs x {n_iter} DDIM steps, seed {seed}: graph replay vs "
            f"eager loop bit-equal {same} (rel-L2 {rel_l2(got, eager):.3e}); captures "
            f"{gen.graphs.captures} (before {captures}); launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if not same or not torch.isfinite(got).all():
            raise AssertionError(f"[{tag}] the graph's latents differ from the eager loop's")
        _require_launches(launches, expect, f"{tag} replay")
        first = got if first is None else first
    if gen.graphs.captures != captures:
        raise AssertionError(f"[{tag}] a call with other prompts and seed captured again")
    times = {"eager": [], "graph": []}
    for which in ("eager", "graph", "graph", "eager"):
        run = plan.run_eager if which == "eager" else (lambda: gen.run_plan(plan))
        times[which].append(_host_s(run)[1])
    log(f"[{tag}] step loop + final denoise ({_loop_calls(plan.spec)} forwards at batch "
        f"{2 * n_imgs}): graph {np.mean(times['graph']):.4f} s, eager "
        f"{np.mean(times['eager']):.4f} s (runs graph {times['graph']}, eager "
        f"{times['eager']}); graphs held {len(gen.graphs)}")

    other = Denoiser.from_config(tr.cfg.denoiser_cfg, dtype=torch.bfloat16)
    gen.model.load_state_dict(init_random_weights_(other, 5).state_dict())
    del other
    plan = _plan(tr, *calls[0], n_imgs, n_iter)
    (once, t_once), ((got, t_capture), held) = (
        _host_s(lambda: gen.run_plan(plan)), _held_gib(lambda: _host_s(lambda: gen.run_plan(plan))))
    eager = plan.run_eager()
    log(f"[{tag}] after load_state_dict (other weights): first call {t_once:.4f} s (eager), "
        f"second {t_capture:.4f} s (captures {gen.graphs.captures}, was {captures}; the graph "
        f"holds {held:.3f} GiB); both bit-equal to the eager loop {torch.equal(once, eager)} "
        f"{torch.equal(got, eager)}, rel-L2 to the old weights' result {rel_l2(got, first):.3f}")
    if (not torch.equal(got, eager) or not torch.equal(once, eager)
            or gen.graphs.captures != captures + 1 or torch.equal(got, first)):
        raise AssertionError(f"[{tag}] the graph did not follow the new weights")
    torch.cuda.synchronize()


def phase_graph_keys(tr):
    """What a key's graph costs on the HTTP default request's loop (1 image,
    15 DPM++ steps, the bf16 engine) on a new generator: its first four
    calls (eager, capture, two replays) beside the eager loop, the device
    memory the capture holds, a mix of KEYS_MIX keys cycling in turn (more
    than the generator keeps: every call runs eagerly, none captures),
    and a new generator for each call, as each training eval builds one."""
    from transformer_latent_diffusion_tpu_torch.sampling import graph as tg
    from transformer_latent_diffusion_tpu_torch.sampling.diffusion import DiffusionGenerator

    def new_gen():
        return DiffusionGenerator(tr.diffuser.model, fast_apply=tr.diffuser.fast_apply,
                                  device=DEVICE)

    gen = new_gen()
    plan = _plan(tr, "a cute cat", 11, 1, KEYS_ITER, gen, sampler="dpm")
    eager = [_host_s(plan.run_eager)[1] for _ in range(2)]
    first = [_host_s(lambda: gen.run_plan(plan))[1]]
    (_, t), held = _held_gib(lambda: _host_s(lambda: gen.run_plan(plan)))
    first.append(t)
    first += [_host_s(lambda: gen.run_plan(plan))[1] for _ in range(2)]
    log(f"[graph-keys] 1 image x {KEYS_ITER} DPM++ steps (batch 2), a new generator: calls "
        f"{', '.join(f'{x:.4f}' for x in first)} s (eager, capture, replay, replay); the "
        f"eager loop {', '.join(f'{x:.4f}' for x in eager)} s; the capture holds {held:.4f} "
        f"GiB; captures {gen.graphs.captures}")
    if gen.graphs.captures != 1:
        raise AssertionError("[graph-keys] the second call did not capture")

    mix = [_plan(tr, "a cute cat", 11, 1, KEYS_ITER + 1 + k, gen, sampler="dpm")
           for k in range(KEYS_MIX)]
    t_mix = [_host_s(lambda: gen.run_plan(p))[1] for _ in range(2) for p in mix]
    t_eager = [_host_s(p.run_eager)[1] for p in mix]
    log(f"[graph-keys] {KEYS_MIX} keys (n_iter {KEYS_ITER + 1}-{KEYS_ITER + KEYS_MIX}) "
        f"cycled twice, the generator keeping {tg.MAX_GRAPHS}: mean {np.mean(t_mix):.4f} s a "
        f"call (runs {[round(x, 4) for x in t_mix]}), eager loops {np.mean(t_eager):.4f} s; "
        f"captures {gen.graphs.captures}")
    if gen.graphs.captures != 1:
        raise AssertionError("[graph-keys] a cycle of more keys than kept captured")

    def one_shot():
        other = new_gen()
        return other.run_plan(_plan(tr, "a cute cat", 11, 1, KEYS_ITER, other, sampler="dpm"))

    t_one = [_host_s(one_shot)[1] for _ in range(3)]
    log(f"[graph-keys] a new generator for each call (as each training eval builds one; "
        f"the CLIP encode, the weights packed, then its one call runs eagerly): "
        f"{', '.join(f'{x:.4f}' for x in t_one)} s")
    del gen, plan, mix
    torch.cuda.synchronize()


def _paired(f, g, errs):
    """A denoiser call that returns f's result and appends to errs the
    rel-L2 of f's prediction against g's on the same inputs."""
    def call(*args):
        a, b = f(*args), g(*args)
        errs.append(rel_l2(a[0] if isinstance(a, tuple) else a,
                           b[0] if isinstance(b, tuple) else b))
        return a
    return call


def phase_sampler_extras(tr):
    """heun, eta = 0.5, cfg_rescale = 0.7, a guidance interval and block
    caching (cache_interval = 2) on the 256 px bf16 engine, each through
    its captured graph: bit-equal to the same loop run eagerly, in which
    every engine call is held against the plain bf16 Denoiser's call on
    the same inputs (the engine with the plain stack for block caching)
    within ENGINE_REL_L2; the exact launches of each replay (block
    caching's from the engine's `cache_span`). The whole trajectory's
    rel-L2 to the plain loop is printed, not bounded: the two loops' states
    part further at each step."""
    from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import make_fused_apply
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
    from transformer_latent_diffusion_tpu_torch.sampling.diffusion import (
        DiffusionGenerator,
        sample_loop,
    )

    gen = tr.diffuser
    den = tr.cfg.denoiser_cfg
    plain = _plain_twin(gen.model, den)
    plain_gen = DiffusionGenerator(plain, device=DEVICE)
    plain_engine = make_fused_apply(den, compute_dtype=torch.bfloat16)
    plain_engine._stack = fs.fused_layer_stack_plain
    plain_cached = DiffusionGenerator(gen.model, fast_apply=plain_engine, device=DEVICE)
    s, e = gen.fast_apply.cache_span()
    labels, _ = tr._encode_prompts(["a cute cat"] * EXTRA_IMGS, None, EXTRA_IMGS)
    common = dict(num_imgs=EXTRA_IMGS, n_iter=EXTRA_ITER, seed=11, img_size=den.image_size,
                  class_guidance=6)
    for name, kw in (("heun", dict(sampler="heun")),
                     ("eta 0.5", dict(sampler="ddim", eta=0.5)),
                     ("cfg_rescale 0.7", dict(sampler="dpm", cfg_rescale=0.7)),
                     ("guidance_interval (0.2, 0.8)",
                      dict(sampler="dpm", guidance_interval=(0.2, 0.8))),
                     ("cache_interval 2", dict(sampler="ddim", cache_interval=2))):
        plan = gen.plan_loop(labels, **common, **kw)
        spec = plan.spec
        ref_gen = plain_cached if spec.cache_interval > 1 else plain_gen
        ref = ref_gen.plan_loop(labels, **common, **kw)
        errs = []
        with torch.no_grad():
            eager = sample_loop(spec, _paired(plan.forward, ref.forward, errs), **plan.inputs,
                                forward_cached=plan.forward_cached and _paired(
                                    plan.forward_cached, ref.forward_cached, errs))
        captures = gen.graphs.captures
        for _ in range(2):  # the key's eager first call, then its capture
            gen.run_plan(plan)
        _reset_counts()
        got, secs = _host_s(lambda: gen.run_plan(plan))
        launches = _counts()
        if spec.cache_interval > 1:
            refresh = sum(1 for i in range(spec.n_steps) if i % spec.cache_interval == 0)
            layers = den.n_layers * (spec.n_steps + 1) - (e - s) * (spec.n_steps - refresh)
        else:
            layers = den.n_layers * _loop_calls(spec)
        traj = rel_l2(got, ref.run_eager())
        expect = _expect({k: v * layers for k, v in fs.LAUNCHES_PER_LAYER.items()})
        log(f"[sampler-extras] {name}: {EXTRA_IMGS} imgs x {EXTRA_ITER} steps through the "
            f"graph ({gen.graphs.captures - captures} capture, replay {secs:.4f} s), bit-equal "
            f"to the eager loop {torch.equal(got, eager)}; its {len(errs)} engine calls vs the "
            f"plain bf16 {'engine stack' if spec.cache_interval > 1 else 'Denoiser'} on the "
            f"same inputs: rel-L2 max {max(errs):.5f} (bound {ENGINE_REL_L2}), mean "
            f"{np.mean(errs):.5f}; the whole trajectory vs the plain loop {traj:.5f} (not "
            f"bounded); launches {dict((k, v) for k, v in launches.items() if v)} ({layers} "
            f"layer calls)")
        if gen.graphs.captures != captures + 1 or not torch.isfinite(got).all():
            raise AssertionError(f"[sampler-extras] {name}: no capture or non-finite latents")
        if not torch.equal(got, eager):
            raise AssertionError(f"[sampler-extras] {name}: the graph differs from the eager loop")
        if max(errs) >= ENGINE_REL_L2:
            raise AssertionError(f"[sampler-extras] {name} disagrees with the plain version")
        _require_launches(launches, expect, f"sampler-extras {name}")
    del plain, plain_gen, plain_cached
    torch.cuda.synchronize()


# ------------------------------ image editing ------------------------------

# [editing] on the 256 px flagship and its full-width float32 VAE (the
# encoder's convolutions on cuDNN, TF32 off as phase_env sets it):
# image_to_image and inpaint at the library workload's size (32 images,
# 50 steps, CFG 6; the entry points' DPM++(2M) solver, the same denoiser
# calls as DDIM), outpaint (the flagship widened by expand_input_channels,
# 2 tiles of one image), interpolate (8 frames), the HTTP service's
# init_image and mask requests at its defaults
EDIT_IMGS, EDIT_ITER, EDIT_STRENGTH = 32, 50, 0.5
ENCODE_CHECK_IMGS = 2
# the card's float32 encode against the CPU's on the same weights, images
# and eps: rel-L2 of the latent sample. Both float32, the convolutions
# summed in other orders (cuDNN without TF32 against oneDNN), so float32
# rounding through the encoder's ~30 layers; the bound leaves room for
# two orders of magnitude more than that
ENCODE_REL_L2 = 1e-4
OUTPAINT_TILES, OUTPAINT_ITER = 2, 15
INTERP_FRAMES, INTERP_ITER = 8, 15
# the outpaint fine-tune's train.main: 2 warm-up steps, then the timed ones
OUTPAINT_WARM, OUTPAINT_STEPS = 2, 5


def _record_plans(gen):
    """Wrap gen.run_plan so each call's (plan, x0) is appended to the list
    returned (`del gen.run_plan` restores it)."""
    calls = []
    run = gen.run_plan

    def recording(plan):
        out = run(plan)
        calls.append((plan, out.clone()))
        return out

    gen.run_plan = recording
    return calls


def _plain_twin(model, den):
    """The plain bf16 Denoiser (no kernels) on `model`'s weights."""
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser

    plain = Denoiser.from_config(den, dtype=torch.bfloat16)
    plain.load_state_dict(model.state_dict())
    return plain.to(DEVICE).eval()


def _edit_calls(tag, gen, calls, run, n_runs, per_run, plain=None):
    """Run `run()` n_runs times, each with its launches counted: the runs'
    host seconds and loops' launches, the last run's replay bit-equal to
    its plan run eagerly, and (with `plain`) every engine call of that
    eager loop against the plain bf16 Denoiser's call on the same inputs
    within ENGINE_REL_L2. `per_run`: the loops (plans) one run makes.
    Returns (seconds per run, the last run's result, its last plan, that
    plan's x0, the engine calls' rel-L2s)."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
    from transformer_latent_diffusion_tpu_torch.sampling.diffusion import sample_loop

    n_layers = len(gen.model.denoiser_trans_block.decoder_blocks)
    secs = []
    for _ in range(n_runs):
        calls.clear()
        _reset_counts()
        out, t = _host_s(run)
        secs.append(t)
        launches = _counts()
        if len(calls) != per_run:
            raise AssertionError(f"[editing] {tag}: {len(calls)} loops, expected {per_run}")
        loop_calls = sum(_loop_calls(plan.spec) for plan, _ in calls)
        _require_launches(launches, _expect({k: v * n_layers * loop_calls
                                             for k, v in fs.LAUNCHES_PER_LAYER.items()}),
                          f"editing {tag}")
    plan, got = calls[-1]
    eager = plan.run_eager()
    if not torch.equal(got, eager) or not torch.isfinite(got).all():
        raise AssertionError(f"[editing] {tag}: the replay differs from the eager loop")
    errs = []
    if plain is not None:
        with torch.no_grad():
            sample_loop(plan.spec, _paired(plan.forward, plain, errs), **plan.inputs)
        if max(errs) >= ENGINE_REL_L2:
            raise AssertionError(f"[editing] {tag}: an engine call disagrees with plain bf16")
    return secs, out, plan, got, errs


def phase_editing(tr, smi):
    """The editing entry points on the 256 px flagship (the K1 engine,
    the sampler's graph): the VAE encode of EDIT_IMGS images timed and
    held against the CPU's; image_to_image and inpaint at EDIT_IMGS x
    EDIT_ITER, CFG 6 (a call eager, one the capture, one a replay;
    the replay bit-equal to its loop run eagerly, every engine call of it
    against the plain bf16 Denoiser's, the exact K1 launches, inpaint's
    keep region bit-equal to the init latents); outpaint with the widened
    flagship (its output against the plain-width engine's, any context),
    2 tiles twice; interpolate (8 frames, prompt_b and seed_b); and the
    HTTP service's init_image and mask requests."""
    import base64
    import io

    from PIL import Image

    from transformer_latent_diffusion_tpu_torch.models.denoiser import (
        Denoiser,
        expand_input_channels,
    )
    from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import make_fused_apply
    from transformer_latent_diffusion_tpu_torch.sampling.diffusion import DiffusionGenerator
    from transformer_latent_diffusion_tpu_torch.serve.app import GenerationService

    t_phase = time.perf_counter()
    gen, den, vae = tr.diffuser, tr.cfg.denoiser_cfg, tr.vae
    size = den.image_size
    px = 8 * size
    rng = np.random.default_rng(0)
    # smooth random images (a coarse noise upsampled), so the latents are
    # not the encoder's response to pixel noise
    coarse = rng.integers(0, 256, (EDIT_IMGS, px // 16, px // 16, 3)).astype(np.float32)
    imgs = torch.nn.functional.interpolate(
        torch.from_numpy(coarse).permute(0, 3, 1, 2), size=(px, px), mode="bilinear",
        align_corners=False).round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()

    # the encode: timed at EDIT_IMGS, checked against the CPU on 2
    x = torch.from_numpy(imgs.astype(np.float32) / 127.5 - 1.0).permute(0, 3, 1, 2)
    x = x.contiguous().to(DEVICE)
    enc_ms = time_ms(lambda: vae.encode(x), reps=3, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    vae.encode(x)
    enc_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = ENCODE_CHECK_IMGS
    eps = torch.randn((n, 4, size, size), generator=torch.Generator().manual_seed(1))
    cpu_vae = copy.deepcopy(vae).cpu()
    t0 = time.perf_counter()
    want = cpu_vae.encode(x[:n].cpu(), eps=eps)
    cpu_s = time.perf_counter() - t0
    del cpu_vae
    got = vae.encode(x[:n], eps=eps)
    enc_err = rel_l2(got.cpu(), want)
    log(f"[editing] VAE encode (full width, float32, cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}) of {EDIT_IMGS} images of {px} px: {enc_ms:.3f} ms "
        f"({EDIT_IMGS / enc_ms * 1e3:.1f} images/s), peak {enc_peak:.2f} GiB; {n} images vs the "
        f"CPU's float32 encode ({cpu_s:.1f} s) on the same eps: rel-L2 {enc_err:.2e} (bound "
        f"{ENCODE_REL_L2}) | {smi}")
    if not (torch.isfinite(got).all() and enc_err < ENCODE_REL_L2):
        raise AssertionError("[editing] the card's encode disagrees with the CPU's")

    plain = _plain_twin(gen.model, den)
    calls = _record_plans(gen)
    prompt = "a cute cat"
    # img2img: eager, capture, replay
    captures, replays = gen.graphs.captures, gen.graphs.replays
    secs, grid, plan, got, errs = _edit_calls(
        "image_to_image", gen, calls, lambda: tr.image_to_image(
            imgs, prompt, strength=EDIT_STRENGTH, n_iter=EDIT_ITER, class_guidance=6,
            seed=11), 3, 1, plain)
    if (gen.graphs.captures - captures, gen.graphs.replays - replays) != (1, 2):
        raise AssertionError("[editing] image_to_image: not eager, capture, replay")
    log(f"[editing] image_to_image {EDIT_IMGS} imgs, strength {EDIT_STRENGTH}, {EDIT_ITER} "
        f"steps ({plan.spec.n_steps} run, DPM++), CFG 6: {', '.join(f'{t:.3f}' for t in secs)} s "
        f"(eager, capture, replay: {EDIT_IMGS / secs[-1]:.3f} images/s); replay bit-equal to "
        f"the eager loop; its {len(errs)} engine calls vs plain bf16: rel-L2 max "
        f"{max(errs):.5f} (bound {ENGINE_REL_L2}), mean {np.mean(errs):.5f}; grid {grid.size} "
        f"| {smi}")

    # inpainting: the top half regenerated, the bottom half kept
    mask = np.zeros((px, px), np.uint8)
    mask[: px // 2] = 255
    captures, replays = gen.graphs.captures, gen.graphs.replays
    secs, grid, plan, got, errs = _edit_calls(
        "inpaint", gen, calls, lambda: tr.inpaint(
            imgs, mask, prompt, n_iter=EDIT_ITER, class_guidance=6, seed=11), 3, 1, plain)
    keep = plan.inputs["mask"] == 0
    kept = torch.equal(got[keep], plan.inputs["init"][keep])
    log(f"[editing] inpaint {EDIT_IMGS} imgs, half mask, strength 1.0, {EDIT_ITER} steps: "
        f"{', '.join(f'{t:.3f}' for t in secs)} s (eager, capture, replay: "
        f"{EDIT_IMGS / secs[-1]:.3f} images/s); replay bit-equal to the eager loop, keep region "
        f"({int(keep.sum())} values) bit-equal to init {kept}; engine calls vs plain bf16 "
        f"rel-L2 max {max(errs):.5f}, mean {np.mean(errs):.5f} | {smi}")
    if (gen.graphs.captures - captures, gen.graphs.replays - replays) != (1, 2) or not kept:
        raise AssertionError("[editing] inpaint: the keep region moved, or no capture")

    # interpolate: 8 frames, both axes
    secs, strip, plan, got, _ = _edit_calls(
        "interpolate", gen, calls, lambda: tr.interpolate(
            prompt, "a red car on a road", n_frames=INTERP_FRAMES, seed=11, seed_b=12,
            n_iter=INTERP_ITER), 3, 1)
    if strip.size != (4 + INTERP_FRAMES * (px + 4), px + 8):
        raise AssertionError(f"[editing] interpolate strip {strip.size}")
    log(f"[editing] interpolate {INTERP_FRAMES} frames (prompt_b, seed_b), {INTERP_ITER} steps: "
        f"{', '.join(f'{t:.3f}' for t in secs)} s (eager, capture, replay); replay bit-equal")

    # HTTP: init_image and init_image + mask at the service's defaults
    def b64(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    http = {}
    with _wsgi_server(GenerationService(transformer=tr)) as request:
        for name, body in (("init_image", {"init_image": b64(imgs[0])}),
                           ("init_image + mask", {"init_image": b64(imgs[1]),
                                                  "mask": b64(mask)})):
            http[name] = []
            for i in range(3):
                t0 = time.perf_counter()
                status, out = request("/generate-image/", {"prompt": f"a cat {i}", **body})
                http[name].append(time.perf_counter() - t0)
                if status != 200 or Image.open(io.BytesIO(out)).size != (px + 8, px + 8):
                    raise AssertionError(f"[editing] POST {name} -> {status} {out[:200]!r}")
    log("[editing] HTTP (1 image, 15-step DPM++, strength 0.5 / 1.0 with the mask): "
        + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)} s (eager, capture, replay)"
                    for k, v in http.items()) + f" | {smi}")

    # outpaint: the flagship widened with zero rows
    wide_cfg = dataclasses.replace(den, input_channels=2 * den.n_channels)
    wide = Denoiser.from_config(wide_cfg, dtype=torch.bfloat16)
    wide.load_state_dict(expand_input_channels(gen.model.state_dict(), den.n_channels,
                                               2 * den.n_channels, den.patch_size))
    wide.to(DEVICE).eval()
    engine = make_fused_apply(wide_cfg)
    g = torch.Generator().manual_seed(2)
    xb = torch.randn(2 * EDIT_IMGS, 4, size, size, generator=g).to(DEVICE)
    ctx = torch.randn(2 * EDIT_IMGS, 4, size, size, generator=g).to(DEVICE) * 3
    lvl = torch.full((2 * EDIT_IMGS, 1), 0.5, device=DEVICE)
    lab = torch.randn(2 * EDIT_IMGS, den.text_emb_size, generator=g).to(DEVICE)
    with torch.no_grad():
        w_out = engine.apply_prepared(engine.prepare(wide.state_dict()),
                                      torch.cat([xb, ctx], 1), lvl, lab)
        n_out = gen.fast_apply.apply_prepared(
            gen.fast_apply.prepare(gen.model.state_dict()), xb, lvl, lab)
    zero_row = rel_l2(w_out, n_out)
    log(f"[editing] widened flagship (expand_input_channels, zero rows) vs the plain-width "
        f"engine, batch {2 * EDIT_IMGS}, a random context: rel-L2 {zero_row:.3e}, bit-equal "
        f"{torch.equal(w_out, n_out)} (bound {ENGINE_REL_L2}; the prologue's K 16 -> 32)")
    if not zero_row < ENGINE_REL_L2:
        raise AssertionError("[editing] the widened model's zero rows changed the output")
    del w_out, n_out, xb, ctx
    base_gen = tr.diffuser
    tr.diffuser = DiffusionGenerator(wide, vae=vae, fast_apply=engine, device=DEVICE)
    try:
        wcalls = _record_plans(tr.diffuser)
        secs, pan, plan, got, errs = _edit_calls(
            "outpaint", tr.diffuser, wcalls, lambda: tr.outpaint(
                imgs[0], "a mountain lake", n_tiles=OUTPAINT_TILES, n_iter=OUTPAINT_ITER),
            2, OUTPAINT_TILES, _plain_twin(wide, wide_cfg))
        graphs = tr.diffuser.graphs
        if pan.size != (px + OUTPAINT_TILES * px // 2, px) or (graphs.captures,
                                                               graphs.replays) != (1, 3):
            raise AssertionError(f"[editing] outpaint {pan.size}, graphs "
                                 f"{graphs.captures}/{graphs.replays}")
        log(f"[editing] outpaint, widened flagship, {OUTPAINT_TILES} tiles right, "
            f"{OUTPAINT_ITER} steps a tile: {', '.join(f'{t:.3f}' for t in secs)} s (tile 1 "
            f"eager and tile 2 the capture, then both replays); the last replay bit-equal; its "
            f"engine calls vs plain bf16 rel-L2 max {max(errs):.5f}; panorama {pan.size}")
    finally:
        tr.diffuser = base_gen
    del gen.run_plan
    del plain, wide, engine
    torch.cuda.empty_cache()
    log(f"[editing] serving part in {time.perf_counter() - t_phase:.1f} s")


def phase_outpaint_train(per_layer, smi):
    """The outpaint fine-tune on the widened flagship at batch TB: one
    step's gradients with the fused layers (K2) against the plain bf16
    autograd Denoiser on the same draws (the context mask among them);
    then train.main with outpaint=True from the widened weights, an eval
    grid at step 0 (K1) and OUTPAINT_WARM + OUTPAINT_STEPS steps, its ms
    per step (the timed ones) and peak memory, with exact launches."""
    from transformer_latent_diffusion_tpu_torch.configs import TrainConfig
    from transformer_latent_diffusion_tpu_torch.models.denoiser import (
        Denoiser,
        expand_input_channels,
    )
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
    from transformer_latent_diffusion_tpu_torch.train import train as tt
    from transformer_latent_diffusion_tpu_torch.utils.common import init_random_weights_

    t_phase = time.perf_counter()
    den = flagship_configs().denoiser_cfg
    wide_cfg = dataclasses.replace(den, input_channels=2 * den.n_channels)
    base = init_random_weights_(Denoiser.from_config(den), 0)
    wide_sd = expand_input_channels(base.state_dict(), den.n_channels,
                                    2 * den.n_channels, den.patch_size)
    del base
    models = {}
    for fused in (True, False):
        mdl = Denoiser.from_config(wide_cfg, dtype=torch.bfloat16, fused_layer_vjp=fused)
        mdl.load_state_dict(wide_sd)
        models[fused] = mdl.to(DEVICE).train()
    g = torch.Generator().manual_seed(4)
    x = torch.randn(TB, 4, den.image_size, den.image_size, generator=g).to(DEVICE)
    y = torch.randn(TB, den.text_emb_size, generator=g).to(DEVICE)
    glob, leaf, leaf_name = _grad_check(models, x, y, TrainConfig(batch_size=TB, outpaint=True))
    log(f"[editing] outpaint fine-tune step, widened flagship, batch {TB}: gradients, kernels "
        f"vs plain bf16 autograd, same draws: global rel-L2 {glob:.5f} (bound "
        f"{STEP_GRAD_REL_L2}), worst leaf {leaf:.5f} {leaf_name} (bound {STEP_GRAD_LEAF_REL_L2})")
    if not (glob < STEP_GRAD_REL_L2 and leaf < STEP_GRAD_LEAF_REL_L2):
        raise AssertionError("[editing] the outpaint step's gradients disagree with plain")
    del models, x, y
    torch.cuda.empty_cache()

    steps = OUTPAINT_WARM + OUTPAINT_STEPS
    times = []
    real_step = tt.train_step

    def timed_step(*args, **kw):
        torch.cuda.synchronize()
        if len(times) == OUTPAINT_WARM:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = real_step(*args, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(1)
        shape = (steps * TB, den.n_channels, den.image_size, den.image_size)
        np.save(os.path.join(tmp, "latents.npy"), rng.standard_normal(shape, dtype=np.float32))
        np.save(os.path.join(tmp, "text_emb.npy"),
                rng.standard_normal((steps * TB, den.text_emb_size), dtype=np.float32))
        np.save(os.path.join(tmp, "val_emb.npy"),
                rng.standard_normal((8, den.text_emb_size), dtype=np.float32))
        cfg = train_configs(tmp, outpaint=True, save_model=False,
                            save_and_eval_every_iters=1000)
        cfg.denoiser_config = wide_cfg
        tt.train_step = timed_step
        try:
            _reset_counts()
            r = tt.main(cfg, device=DEVICE, init_state_dict=wide_sd)
            launches = {k: v for k, v in _counts().items() if v}
        finally:
            tt.train_step = real_step
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = float(np.mean(times[OUTPAINT_WARM:])) * 1e3
    expect = {k: v * den.n_layers * steps for k, v in per_layer.items()}
    for k, v in fs.LAUNCHES_PER_LAYER.items():
        expect[k] = expect.get(k, 0) + v * den.n_layers * EVAL_CALLS
    log(f"[editing] outpaint fine-tune, train.main (outpaint=True, widened flagship), batch "
        f"{TB}: {r['global_step']} steps, {ms:.2f} ms/step over the last {OUTPAINT_STEPS} "
        f"({TB / ms * 1e3:.1f} samples/s; each step synchronised), peak memory {peak:.2f} GiB; "
        f"losses {' '.join(f'{v:.3f}' for v in r['losses'])}; launches {launches} "
        f"(phase {time.perf_counter() - t_phase:.1f} s) | {smi}")
    if r["global_step"] != steps or not all(np.isfinite(r["losses"])):
        raise AssertionError(f"[editing] outpaint train.main: {r['global_step']} steps")
    _require_launches(launches, {k: v for k, v in expect.items() if v},
                      "editing outpaint train.main")
    del r
    torch.cuda.empty_cache()
    return ms, peak


# ------------------------------ int8 serving (K7) ------------------------------


def phase_int8_kernels():
    """K7's kernels against their plain versions at the main path's shapes
    (M = B*N = 16384 rows): rowquant with LN (K = 768) and without (the
    GELU output, K = 3072), int8 values within one step; gemm_i8 at the
    four product shapes on the same int8 operands as its plain version;
    dwconv_gelu with its float32 output. Times per layer, bounds, and
    torch._int_mm (int32 out, no epilogue) as gemm_i8's yardstick."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack_int8 as q8

    dev = torch.device(DEVICE)
    g = torch.Generator(device="cpu").manual_seed(13)
    f32 = torch.float32

    def randn(*shape, std=1.0, dtype=f32):
        return (torch.randn(*shape, generator=g) * std).to(dev, dtype)

    m = B * N
    x = randn(m, D)
    ln = (1.0 + randn(D, std=0.1), randn(D, std=0.1))
    act = torch.nn.functional.gelu(randn(m, HIDDEN))  # a GELU output's distribution
    b1, b2 = randn(HIDDEN, std=0.1), randn(D, std=0.1)
    worst = {}
    for name, args in (("LN, K=768", (x, ln)), ("no LN, K=3072", (act, None))):
        q, rs = q8.rowquant(*args)
        qp, rsp = q8.rowquant_plain(*args)
        diff = (q.int() - qp.int()).abs()
        share = float((diff > 0).float().mean())
        srel = float(((rs - rsp).abs() / rsp).max())
        log(f"[int8-kernels] rowquant {name}: int8 max |diff| {int(diff.max())}, share "
            f"differing {share:.2e} (bound {ROWQUANT_FLIP_SHARE}), scale max rel diff {srel:.2e}")
        if int(diff.max()) > 1 or share > ROWQUANT_FLIP_SHARE or srel > 1e-6:
            raise AssertionError(f"rowquant {name} disagrees with its plain version")
        worst["rowquant"] = max(worst.get("rowquant", 0.0), float(diff.max()))
    xq, rs = q8.rowquant_plain(x, ln)
    aq, ars = q8.rowquant_plain(act)
    # the four projections of a layer, quantized per output channel from bf16
    w = {name: q8.colquant(randn(n, k, std=k ** -0.5, dtype=torch.bfloat16))
         for name, (n, k) in {"qkv": (3 * D, D), "q": (D, D), "expand": (HIDDEN, D),
                              "contract": (D, HIDDEN)}.items()}
    products = {  # name: (A, row scales, kwargs)
        "qkv": (xq, rs, {}), "q": (xq, rs, {}),
        "expand": (xq, rs, {"bias": b1, "out_dtype": f32}),
        "contract": (aq, ars, {"bias": b2, "residual": x})}

    def run(fn, name, residual=None):
        a, r, kw = products[name]
        kw = dict(kw, residual=residual) if "residual" in kw else kw
        return fn(a, r, *w[name], **kw)

    # a ragged last column tile: the QKV product of a 3-head (D = 192) layer
    # is 576 wide; here on the flagship's rows
    w["qkv576"] = q8.colquant(randn(576, D, std=D ** -0.5, dtype=torch.bfloat16))
    products["qkv576"] = (xq, rs, {})
    for name in products:
        got = run(q8.gemm_i8, name, x.clone())
        again = run(q8.gemm_i8, name, x.clone())
        want = run(q8.gemm_i8_plain, name, x)
        err = float((got.float() - want.float()).abs().max())
        rel = err / float(want.float().abs().max())
        same = torch.equal(got, want)
        log(f"[int8-kernels] gemm_i8/{name} on the plain version's int8 operands: max-abs "
            f"{err:.3e} ({rel:.2e} of max |ref|, bound {GEMM_I8_MAX_ABS}), bit-equal to the "
            f"plain version: {same}, two launches bit-equal: {torch.equal(got, again)}")
        if not (rel <= GEMM_I8_MAX_ABS and same and torch.equal(got, again)):
            raise AssertionError(f"gemm_i8/{name} disagrees with its plain version")
        worst["gemm_i8"] = max(worst.get("gemm_i8", 0.0), err)
    del products["qkv576"], got, again, want
    _ptxas_report("int8-kernels", ("gemm_i8_kernel",))
    h = randn(m, HIDDEN)
    dw, dwb = randn(9, HIDDEN, std=1 / 3, dtype=torch.bfloat16), randn(HIDDEN, std=0.1)
    _check("dwconv_gelu float32 in and out", (fs.dwconv_gelu(h, dw, dwb, HW, out_dtype=f32),),
           (fs.dwconv_gelu_plain(h, dw, dwb, HW, out_dtype=f32),), "int8-kernels")
    _bit_equal_twice("dwconv_gelu float32 in and out",
                     lambda: fs.dwconv_gelu(h, dw, dwb, HW, out_dtype=f32), "int8-kernels")
    torch.cuda.synchronize()

    xr = x.clone()
    layer = {  # name: (the kernels of one layer, their plain versions)
        "rowquant": (lambda: [q8.rowquant(x, ln) for _ in range(3)] + [q8.rowquant(act)],
                     lambda: [q8.rowquant_plain(x, ln) for _ in range(3)]
                     + [q8.rowquant_plain(act)]),
        "gemm_i8": (lambda: [run(q8.gemm_i8, k, xr) for k in products],
                    lambda: [run(q8.gemm_i8_plain, k, x) for k in products])}
    timing = time_against_plain(layer, "int8-kernels")
    ops = {"qkv": (m, 3 * D, D), "q": (m, D, D), "expand": (m, HIDDEN, D),
           "contract": (m, D, HIDDEN)}
    lib = {}
    for name, (mm, nn, kk) in ops.items():
        ms = time_ms(lambda: run(q8.gemm_i8, name, xr))
        a = products[name][0]
        lib[name] = time_ms(lambda: torch._int_mm(a, w[name][0].t()))
        log(f"[int8-kernels] gemm_i8/{name} ({mm}x{nn}x{kk}): {ms:.4f} ms, "
            f"{2 * mm * nn * kk / ms / 1e9:.1f} TOP/s; torch._int_mm {lib[name]:.4f} ms")
    for name, args in (("LN, K=768", (x, ln)), ("no LN, K=3072", (act, None))):
        log(f"[int8-kernels] rowquant {name}: {time_ms(lambda: q8.rowquant(*args)):.4f} ms")
    log(f"[int8-kernels] dwconv_gelu float32 out: "
        f"{time_ms(lambda: fs.dwconv_gelu(h, dw, dwb, HW, out_dtype=f32)):.4f} ms (bf16 out "
        f"{time_ms(lambda: fs.dwconv_gelu(h, dw, dwb, HW)):.4f} ms; plain, float32 out "
        f"{time_ms(lambda: fs.dwconv_gelu_plain(h, dw, dwb, HW, out_dtype=f32), 3, 1):.4f} ms)")
    library = {"gemm_i8": time_ms(lambda: [torch._int_mm(products[k][0], w[k][0].t())
                                           for k in products]),
               "rowquant": None}  # no one call: a LayerNorm, a row max, a division, a round
    F = torch.nn.functional

    def quant_equal_work(rows, lnp):
        # the same work as rowquant in PyTorch calls: F.layer_norm (where
        # given), the row's |max|, its scale, the rounded int8 values
        y = rows if lnp is None else F.layer_norm(rows, (rows.shape[1],), *lnp, 1e-5)
        scale = y.abs().amax(-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
        return torch.round(y * (1.0 / scale)).to(torch.int8), scale

    library["rowquant (equal work)"] = time_ms(
        lambda: [quant_equal_work(x, ln) for _ in range(3)] + [quant_equal_work(act, None)])
    log(f"[int8-kernels] rowquant: {timing['rowquant'][0]:.4f} ms a layer; equal-work "
        f"yardstick (F.layer_norm + |max| + scale + round, 3 LN rows of 768 and one GELU row "
        f"of 3072) {library['rowquant (equal work)']:.4f} ms")
    log(f"[int8-kernels] dwconv_gelu float32 in and out: equal-work yardstick (F.conv2d "
        f"groups=C with bias + F.gelu, float32) "
        f"{time_ms(dw_equal_work(h, dw, dwb, HW, f32)):.4f} ms")
    # least time per layer: each input read once, each output written once
    gbytes = sum(mm * kk + nn * kk + 4 * (mm + nn) for mm, nn, kk in ops.values()) \
        + m * 3 * D * 2 + m * D * 2 + (m * HIDDEN * 4 + HIDDEN * 4) + (m * D * 8 + D * 4)
    gops = sum(2 * mm * nn * kk for mm, nn, kk in ops.values())
    rbytes = 3 * (m * D * 5 + m * 4 + 2 * D * 4) + m * HIDDEN * 5 + m * 4
    bounds = {"gemm_i8": bound(gbytes, gops, INT8_TENSOR_OP_S),
              "rowquant": bound(rbytes, 3 * 12 * m * D + 4 * m * HIDDEN, F32_FLOP_S)}
    log(f"[int8-kernels] per layer: gemm_i8 {timing['gemm_i8'][0]:.4f} ms (bound "
        f"{bounds['gemm_i8'][0]:.4f} {bounds['gemm_i8'][1]}, torch._int_mm "
        f"{library['gemm_i8']:.4f}); rowquant {timing['rowquant'][0]:.4f} ms (bound "
        f"{bounds['rowquant'][0]:.4f} {bounds['rowquant'][1]})")
    del x, act, h, xq, aq, xr
    torch.cuda.empty_cache()
    return worst, timing, library, bounds


def phase_int8_engine(cfg8):
    """One int8-engine forward at batch B against the plain int8 stack on
    the card (the same engine with every stage's plain version) and the
    plain bf16 Denoiser; its launches, its time beside the bf16 engine's,
    and its device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import make_fused_apply
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack_int8 as q8
    from transformer_latent_diffusion_tpu_torch.utils.common import init_random_weights_

    dev = torch.device(DEVICE)
    den = cfg8.denoiser_cfg
    model = Denoiser.from_config(den, dtype=torch.bfloat16)
    init_random_weights_(model, 0)
    model.to(dev).eval()
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(B, 4, den.image_size, den.image_size, generator=g).to(dev)
    noise = torch.full((B, 1), 0.5, device=dev)
    label = torch.randn(B, den.text_emb_size, generator=g).to(dev)
    engine = make_fused_apply(den, compute_dtype=torch.bfloat16, quantize=cfg8.quantize)
    bf16 = make_fused_apply(den, compute_dtype=torch.bfloat16)
    sd = model.state_dict()
    with torch.no_grad():
        prepared, prepared_bf16 = engine.prepare(sd), bf16.prepare(sd)
        _reset_counts()
        out = engine.apply_prepared(prepared, x, noise, label)
        launches = {k: v for k, v in _counts().items() if v}
        tokens, cond, h, w = engine._prologue(sd, x, noise, label)
        for layer in prepared["layers"]:
            tokens = q8.fused_layer_stack_int8_plain(tokens, cond, layer, h, engine.n_heads)
        plain = engine._epilogue(sd, tokens, h, w)
        ref = model(x, noise, label)
    torch.cuda.synchronize()
    expect = {k: v * den.n_layers for k, v in q8.LAUNCHES_PER_LAYER.items()}
    r = rel_l2(out, plain)
    cos = float(torch.nn.functional.cosine_similarity(
        out.double().flatten(), ref.double().flatten(), dim=0))
    r_ref = rel_l2(out, ref)
    log(f"[int8-engine] W8A8 engine vs the plain int8 stack, batch {B}: rel-L2 {r:.5f} "
        f"(bound {INT8_ENGINE_REL_L2}); vs the plain bf16 forward: cos {cos:.6f} (bound "
        f"{INT8_COSINE}), rel-L2 {r_ref:.5f}; launches {launches} (expected {expect})")
    if not (torch.isfinite(out).all() and r < INT8_ENGINE_REL_L2 and cos > INT8_COSINE):
        raise AssertionError("the int8 engine disagrees with its plain version or the "
                             "bf16 forward")
    if launches != expect:
        raise AssertionError(f"int8 engine launches {launches} != {expect}")
    with torch.no_grad():
        fwd8 = lambda: engine.apply_prepared(prepared, x, noise, label)  # noqa: E731
        fwd16 = lambda: bf16.apply_prepared(prepared_bf16, x, noise, label)  # noqa: E731
        t8 = [time_ms(fwd8, 5, 2)]
        t16 = [time_ms(fwd16, 5, 2), time_ms(fwd16, 5, 2)]
        t8.append(time_ms(fwd8, 5, 2))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fwd8()
            torch.cuda.synchronize()
    busy, by_kernel = _device_time(prof)
    with torch.no_grad():
        tokens, cond, h, w = engine._prologue(sd, x, noise, label)
        layer0 = prepared["layers"][0]
        t_layer = time_ms(lambda: q8.fused_layer_stack_int8(tokens, cond, layer0, h,
                                                            engine.n_heads))
        t_equal = time_ms(int8_layer_equal_work(tokens, cond, layer0, h, engine.n_heads))
    log(f"[int8-engine] one W8A8 layer at batch {B}: kernels {t_layer:.4f} ms; equal-work "
        f"yardstick (F.layer_norm + |max| + round, torch._int_mm + scales, SDPA, F.conv2d + "
        f"F.gelu) {t_equal:.4f} ms")
    # one W8A8 layer's least time: its four int8 products at the int8
    # tensor peak plus the bf16 cond K/V product and self-attention at the
    # bf16 peak (the bytes, about 10 MB of weights and activations, are an
    # order less)
    m = B * N
    layer = (2 * m * D * (3 * D + D + 2 * HIDDEN) / INT8_TENSOR_OP_S
             + (2 * 2 * B * D * 2 * D + 4 * B * HEADS * N * N * 64) / BF16_TENSOR_FLOP_S) * 1e3
    log(f"[int8-engine] one forward at batch {B}: W8A8 {sum(t8) / 2:.3f} ms, bf16 engine "
        f"{sum(t16) / 2:.3f} ms (runs {t8}, {t16}); profiled W8A8 forward: device busy "
        f"{busy:.3f} ms ({busy / den.n_layers:.3f} a layer, least time of one W8A8 layer "
        f"{layer:.4f} ms by operations); by kernel, us: {by_kernel}")
    del model, prepared, prepared_bf16


def phase_s1():
    """S1 (scripts/microbench_int8.py) through its entry point,
    `transformer_latent_diffusion_tpu_torch.scripts.microbench_int8`: the
    MLP product pair y = (x W1) W2 at its shapes (x 65,536 x 768, W1
    768 -> 3072, W2 3072 -> 768), bf16 (ln_gemm twice) against W8A8
    (rowquant, gemm_i8 with a float32 hidden state, rowquant, gemm_i8), in
    TFLOP/s; the W8A8 result against its plain version (the probe raises
    past KERNEL_REL_L2) and against the bf16 one."""
    from transformer_latent_diffusion_tpu_torch.scripts import microbench_int8

    res = microbench_int8.main(["--rows", str(S1_ROWS), "--device", DEVICE])
    torch.cuda.empty_cache()
    return res


# ------------------------------ every width 64 x n_heads ------------------------------

# [widths]: the port at embed_dim = 64 x n_heads other than the flagship's
# 768, where the kernels meet ragged tiles (N % 128 != 0), LayerNorm rows
# past 768, more than 12 heads and rowquant rows past 3072. Two layers,
# small batches: a check of the kernels at these widths, not a measurement
WIDTHS_BF16_ENGINE = (192, 1024)
WIDTHS_INT8_ENGINE = (64, 192)
WIDTHS_TRAIN = (64, 192, 1024)
WIDTHS_LAYERS, WIDTHS_B, WIDTHS_TB = 2, 16, 16


def width_config(d, mlp_class="sep_conv"):
    """The flagship deployment at embed_dim d (d / 64 heads), two layers."""
    cfg = flagship_configs()
    return dataclasses.replace(cfg, denoiser_cfg=dataclasses.replace(
        cfg.denoiser_cfg, embed_dim=d, n_layers=WIDTHS_LAYERS, mlp_class=mlp_class))


def _width_forward(d, quantize):
    """One engine forward (bf16, or W8A8 with `quantize`) at embed_dim d
    against the plain bf16 Denoiser (and, for W8A8, the plain int8 stack),
    with the engine's launches."""
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import make_fused_apply
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack_int8 as q8
    from transformer_latent_diffusion_tpu_torch.utils.common import init_random_weights_

    dev = torch.device(DEVICE)
    den = width_config(d).denoiser_cfg
    model = init_random_weights_(Denoiser.from_config(den, dtype=torch.bfloat16), 0).to(dev).eval()
    g = torch.Generator(device="cpu").manual_seed(d)
    x = torch.randn(WIDTHS_B, 4, den.image_size, den.image_size, generator=g).to(dev)
    noise = torch.full((WIDTHS_B, 1), 0.5, device=dev)
    label = torch.randn(WIDTHS_B, den.text_emb_size, generator=g).to(dev)
    engine = make_fused_apply(den, compute_dtype=torch.bfloat16, quantize=quantize)
    with torch.no_grad():
        prepared = engine.prepare(model.state_dict())
        _reset_counts()
        out = engine.apply_prepared(prepared, x, noise, label)
        launches = {k: v for k, v in _counts().items() if v}
        ref = model(x, noise, label)
        plain = None
        if quantize:
            tokens, cond, h, w = engine._prologue(model.state_dict(), x, noise, label)
            for layer in prepared["layers"]:
                tokens = q8.fused_layer_stack_int8_plain(tokens, cond, layer, h, engine.n_heads)
            plain = engine._epilogue(model.state_dict(), tokens, h, w)
    per_layer = q8.LAUNCHES_PER_LAYER if quantize else fs.LAUNCHES_PER_LAYER
    expect = {k: v * den.n_layers for k, v in per_layer.items()}
    r_ref = rel_l2(out, ref)
    cos = float(torch.nn.functional.cosine_similarity(out.double().flatten(),
                                                      ref.double().flatten(), dim=0))
    if quantize:
        r = rel_l2(out, plain)
        log(f"[widths] W8A8 engine at D = {d} ({d // 64} heads), batch {WIDTHS_B}: vs the "
            f"plain int8 stack rel-L2 {r:.5f} (bound {INT8_ENGINE_REL_L2}); vs the plain bf16 "
            f"forward cos {cos:.6f} (bound {INT8_COSINE}), rel-L2 {r_ref:.5f}; launches "
            f"{launches}")
        ok = r < INT8_ENGINE_REL_L2 and cos > INT8_COSINE
    else:
        log(f"[widths] bf16 engine at D = {d} ({d // 64} heads), batch {WIDTHS_B}: vs the "
            f"plain bf16 forward rel-L2 {r_ref:.5f} (bound {ENGINE_REL_L2}), cos {cos:.6f}; "
            f"launches {launches}")
        ok = r_ref < ENGINE_REL_L2
    if not (torch.isfinite(out).all() and ok):
        raise AssertionError(f"the {'W8A8' if quantize else 'bf16'} engine at D = {d} "
                             f"disagrees with its plain version")
    _require_launches(launches, expect, f"the engine at D = {d}")
    del model, prepared


def _width_step(d, mlp_class):
    """One train step's gradients at embed_dim d with the kernels (K2 for
    the sep-conv FFN, K6 for the dense MLP) against the plain bf16 autograd
    Denoiser on the same weights and draws, per parameter group."""
    from transformer_latent_diffusion_tpu_torch.configs import TrainConfig
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.train import train as tt
    from transformer_latent_diffusion_tpu_torch.utils.common import init_random_weights_

    dev = torch.device(DEVICE)
    den = width_config(d, mlp_class).denoiser_cfg
    models = {}
    for fused in (True, False):
        mdl = Denoiser.from_config(den, dtype=torch.bfloat16, fused_layer_vjp=fused,
                                   use_pallas=fused)
        models[fused] = init_random_weights_(mdl, 0).to(dev).train()
    gen = torch.Generator(device="cpu").manual_seed(d + 1)
    x = torch.randn(WIDTHS_TB, 4, den.image_size, den.image_size, generator=gen).to(dev)
    y = torch.randn(WIDTHS_TB, den.text_emb_size, generator=gen).to(dev)
    tc = TrainConfig(batch_size=WIDTHS_TB)
    loss_fn = tt.build_loss_fn(models[True], tc, 8.0)
    draws = loss_fn.sample_draws(torch.Generator(device=dev).manual_seed(d + 2), x)
    grads = {}
    for fused, mdl in models.items():
        _reset_counts()
        loss_fn.loss_from_draws(mdl, x, y, **draws).backward()
        if fused:
            launches = {k: v for k, v in _counts().items() if v}
        grads[fused] = {k: p.grad.float() for k, p in mdl.named_parameters()}
    groups = _param_groups(grads[False])
    stats = {}
    for name in sorted(set(groups.values())):
        keys = [k for k, v in groups.items() if v == name]
        u = torch.cat([grads[True][k].flatten() for k in keys]).double()
        w = torch.cat([grads[False][k].flatten() for k in keys]).double()
        stats[name] = float((u - w).norm() / w.norm())
    route = "K2" if mlp_class == "sep_conv" else "K6"
    bound_ = STEP_GRAD_REL_L2 if mlp_class == "sep_conv" else FFN_GRAD_REL_L2[mlp_class]
    log(f"[widths] {route} train step at D = {d} ({d // 64} heads), batch {WIDTHS_TB}: "
        f"gradients vs plain bf16 autograd per group (rel-L2) "
        + ", ".join(f"{k} {v:.5f}" for k, v in stats.items()) + f" (bound {bound_}); "
        f"launches {launches}")
    if not all(v < bound_ for v in stats.values()):
        raise AssertionError(f"the {route} step at D = {d} disagrees with the plain path")
    need = (("weight_grad", "layernorm_bwd", "cross_attention_bwd", "self_attention_bwd",
             "dwconv_gelu_bwd") if route == "K2" else
            ("fused_attention_pair_vjp", "fused_attention_pair_vjp_bwd"))
    missing = [k for k in need if not launches.get(k)]
    if missing:
        raise AssertionError(f"the {route} step at D = {d} launched no {missing}")
    del models, grads


def phase_widths():
    """[widths]: the bf16 engine at D = 192 and 1024, the W8A8 engine at D
    = 64 and 192, one K2 (sep-conv) and one K6 (dense MLP) train step at D
    = 64, 192 and 1024, each against its plain bf16 version."""
    t0 = time.perf_counter()
    for d in WIDTHS_BF16_ENGINE:
        _width_forward(d, None)
    for d in WIDTHS_INT8_ENGINE:
        _width_forward(d, "int8")
    for d in WIDTHS_TRAIN:
        _width_step(d, "sep_conv")
        _width_step(d, "mlp")
    torch.cuda.empty_cache()
    log(f"[widths] done in {time.perf_counter() - t0:.1f} s")


# ------------------------------ hi-res serving (K3, K5) ------------------------------


def phase_hires_kernels():
    """Flash attention (K3) at the 512 px, 1024 px and a ragged grid's
    shapes and the fused sep-conv MLP (K5's forward) at 512 px against
    their plain versions; times, the SDPA yardstick and bounds."""
    from transformer_latent_diffusion_tpu_torch.ops import attention as att
    from transformer_latent_diffusion_tpu_torch.ops import fused_mlp_vjp as fm
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

    dev = torch.device(DEVICE)
    g = torch.Generator(device="cpu").manual_seed(8)
    bf = torch.bfloat16
    F = torch.nn.functional

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * std).to(dev, dtype)

    worst, timing, library, bounds = {}, {}, {}, {}
    with torch.no_grad():
        for b, n in ((HR_B, HR_N), (XR_B, XR_N), (RAG_B, RAG_N)):
            qkv = randn(b, n, 3 * D, dtype=bf)
            q, k, v = qkv.chunk(3, dim=-1)  # strided row views, as the model passes them
            kern = lambda: att.flash_attention(q, k, v, HEADS)  # noqa: E731
            plain = lambda: att.multi_head_attention(q, k, v, HEADS)  # noqa: E731
            worst["flash_attention"] = max(worst.get("flash_attention", 0.0), _check(
                f"flash_attention B={b} N={n}", (kern(),), (plain(),), "hires-kernels"))
            t = time_against_plain({f"flash_attention B={b} N={n}": (kern, plain)},
                                   "hires-kernels")
            heads = [t_.reshape(b, n, HEADS, 64).transpose(1, 2).contiguous()
                     for t_ in (q, k, v)]
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(*heads))
            bnd = bound(4 * b * n * D * 2, 4 * b * HEADS * n * n * 64, BF16_TENSOR_FLOP_S)
            ms = t[f"flash_attention B={b} N={n}"][0]
            log(f"[hires-kernels] flash_attention B={b} N={n}: {ms:.4f} ms, "
                f"{4 * b * HEADS * n * n * 64 / ms / 1e9:.1f} TFLOP/s; SDPA "
                f"{sdpa:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})")
            # one writer per output element: two launches bit-equal; K3 is
            # S3's exp2,postdiv form of the same body
            first, second = kern(), kern()
            form = att.flash_attention_variant(q, k, v, HEADS, use_exp2=True, postdiv=True)
            if not (torch.equal(first, second) and torch.equal(first, form)):
                raise AssertionError(f"flash_attention B={b} N={n}: two launches, or K3 and "
                                     f"its exp2,postdiv form, differ")
            del first, second, form
            log(f"[hires-kernels] flash_attention B={b} N={n}: two launches bit-equal, and "
                f"bit-equal to flash_attention_variant(exp2, postdiv); host time per call "
                f"{host_ms(kern, reps=20):.4f} ms; {'no slower than' if ms <= sdpa else f'{ms / sdpa:.2f}x'} "
                f"SDPA")
            if n == HR_N:  # the 512 px main path's shape
                timing["flash_attention"] = t[f"flash_attention B={b} N={n}"]
                library["flash_attention"] = sdpa
                bounds["flash_attention"] = bnd
            del qkv, q, k, v, heads

        m = HR_B * HR_N
        x = randn(HR_B, HR_N, D, dtype=bf)
        w1 = randn(HIDDEN, D, std=D ** -0.5, dtype=bf)
        w2 = randn(D, HIDDEN, std=HIDDEN ** -0.5, dtype=bf)
        b1, b2 = randn(HIDDEN, std=0.1), randn(D, std=0.1)
        dw, dwb = randn(9, HIDDEN, std=1 / 3, dtype=bf), randn(HIDDEN, std=0.1)
        args = (x, w1, b1, dw, dwb, w2, b2, HR_HW)
        kern = lambda: fm.fused_mlp_sepconv(*args)  # noqa: E731
        plain = lambda: fm.fused_mlp_sepconv_plain(*args)  # noqa: E731
        worst["fused_mlp_sepconv"] = _check("fused_mlp_sepconv hw=32", (kern(),), (plain(),),
                                            "hires-kernels")
        timing.update(time_against_plain({"fused_mlp_sepconv": (kern, plain)},
                                         "hires-kernels"))
        library["fused_mlp_sepconv"] = None  # no one call: two products around a depthwise conv
        library["fused_mlp_sepconv (equal work)"] = time_ms(
            sepconv_equal_work(x, w1, b1, dw, dwb, w2, b2, HR_HW), 10, 2)
        log(f"[hires-kernels] fused_mlp_sepconv: equal-work yardstick (F.linear, F.conv2d "
            f"groups=C + bias, F.gelu, F.linear, bf16) "
            f"{library['fused_mlp_sepconv (equal work)']:.4f} ms")
        bounds["fused_mlp_sepconv"] = bound(
            2 * m * D * 2 + 2 * HIDDEN * D * 2 + 9 * HIDDEN * 2 + (2 * HIDDEN + D) * 4,
            4 * m * D * HIDDEN, BF16_TENSOR_FLOP_S)
        # its three launches one by one, and the row-band body against its plain version
        x2 = x.reshape(m, D)
        h = fs.ln_gemm(x2, w1, bias=b1, out_dtype=torch.float32)
        a = fs.dwconv_gelu(h, dw, dwb, HR_HW)
        _check("dwconv_gelu float32 row bands hw=32", (a,),
               (fs.dwconv_gelu_plain(h, dw, dwb, HR_HW),), "hires-kernels")
        _bit_equal_twice("dwconv_gelu float32 row bands hw=32",
                         lambda: fs.dwconv_gelu(h, dw, dwb, HR_HW), "hires-kernels")
        log(f"[hires-kernels] dwconv_gelu row bands: equal-work yardstick (F.conv2d groups=C "
            f"with bias + F.gelu in float32, then bf16) "
            f"{time_ms(dw_equal_work(h, dw, dwb, HR_HW)):.4f} ms")
        parts = {"ln_gemm expand (float32 h)": lambda: fs.ln_gemm(x2, w1, bias=b1,
                                                                  out_dtype=torch.float32),
                 "dwconv_gelu row bands": lambda: fs.dwconv_gelu(h, dw, dwb, HR_HW),
                 "ln_gemm contract": lambda: fs.ln_gemm(a, w2, bias=b2)}
        part_bounds = {
            "ln_gemm expand (float32 h)": bound(m * D * 2 + HIDDEN * D * 2 + m * HIDDEN * 4,
                                                2 * m * D * HIDDEN, BF16_TENSOR_FLOP_S),
            "dwconv_gelu row bands": bound(m * HIDDEN * 6, 26 * m * HIDDEN, F32_FLOP_S),
            "ln_gemm contract": bound(m * HIDDEN * 2 + HIDDEN * D * 2 + m * D * 2,
                                      2 * m * D * HIDDEN, BF16_TENSOR_FLOP_S)}
        # the two products against one F.linear on the same operands (bf16 out)
        part_linear = {"ln_gemm expand (float32 h)": lambda: F.linear(x2, w1, b1.to(bf)),
                       "ln_gemm contract": lambda: F.linear(a, w2, b2.to(bf))}
        for name, fn in parts.items():
            ms = time_ms(fn)
            extra = ""
            if name in part_linear:
                extra = (f", {2 * m * D * HIDDEN / ms / 1e9:.1f} TFLOP/s; F.linear "
                         f"{time_ms(part_linear[name]):.4f} ms")
            log(f"[hires-kernels] K5 part {name}: {ms:.4f} ms, bound "
                f"{part_bounds[name][0]:.4f} ms ({part_bounds[name][1]}){extra}")
        del x, x2, h, a
    torch.cuda.synchronize()
    log(f"[hires-kernels] bounds (ms): { {k: round(v[0], 4) for k, v in bounds.items()} }")
    return worst, timing, library, bounds


def hires_config(tmp, image_size):
    """The flagship LTDConfig at `image_size` (64: 512 px, 128: 1024 px),
    whose denoiser file holds the 256 px flagship's seeded random weights
    with the positional table upsampled (train.highres)."""
    import dataclasses

    from transformer_latent_diffusion_tpu_torch.configs import DenoiserLoad
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.train.highres import (
        upsample_denoiser_params,
    )
    from transformer_latent_diffusion_tpu_torch.utils.common import init_random_weights_

    base = flagship_configs()
    den = base.denoiser_cfg
    sd = init_random_weights_(Denoiser.from_config(den), 0).state_dict()
    path = os.path.join(tmp, f"denoiser_{image_size}.pt")
    torch.save(upsample_denoiser_params(sd, den.image_size, image_size, den.patch_size), path)
    return dataclasses.replace(
        base, denoiser_cfg=dataclasses.replace(den, image_size=image_size),
        denoiser_load=DenoiserLoad(dtype="bfloat16", local_filename=path))


def _hires_per_layer(den):
    """Kernel launches per decoder layer on the linen path, by the JAX
    package's gates: flash attention always, the fused MLP (two ln_gemm
    launches, one dwconv_gelu) for a native grid of 16 < hw <= 32."""
    hw = den.image_size // den.patch_size
    per_layer = {"flash_attention": 1}
    if 16 < hw <= 32:
        per_layer.update(fused_mlp_sepconv=1, ln_gemm=2, dwconv_gelu=1)
    return per_layer


def phase_hires_model(cfg):
    """One 512 px Denoiser forward at batch HR_B with the kernels (K3, K5)
    against the same module's plain bf16 forward; its launches and times."""
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.utils.common import load_state_dict_file

    dev = torch.device(DEVICE)
    den = cfg.denoiser_cfg
    sd = load_state_dict_file(cfg.denoiser_load.local_filename)
    models = {}
    for flag in (True, False):
        mdl = Denoiser.from_config(den, dtype=torch.bfloat16, use_pallas=flag,
                                   fused_mlp_vjp=flag)
        mdl.load_state_dict(sd)
        models[flag] = mdl.to(dev).eval()
    g = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn(HR_B, 4, den.image_size, den.image_size, generator=g).to(dev)
    noise = torch.full((HR_B, 1), 0.5, device=dev)
    label = torch.randn(HR_B, den.text_emb_size, generator=g).to(dev)
    with torch.no_grad():
        _reset_counts()
        out = models[True](x, noise, label)
        launches = {k: v for k, v in _counts().items() if v}
        ref = models[False](x, noise, label)
    torch.cuda.synchronize()
    r = rel_l2(out, ref)
    cos = float(torch.nn.functional.cosine_similarity(
        out.double().flatten(), ref.double().flatten(), dim=0))
    expect = {k: v * den.n_layers for k, v in _hires_per_layer(den).items()}
    log(f"[hires-model] 512 px Denoiser, kernels vs plain bf16 forward, batch {HR_B}: "
        f"rel-L2 {r:.5f} (bound {HIRES_MODEL_REL_L2}), cos {cos:.6f}; launches "
        f"{launches} (expected {expect})")
    if not (torch.isfinite(out).all() and r < HIRES_MODEL_REL_L2):
        raise AssertionError("the 512 px kernels' forward disagrees with the plain forward")
    if launches != expect:
        raise AssertionError(f"512 px forward launches {launches} != {expect}")
    with torch.no_grad():
        fwd = lambda flag: models[flag](x, noise, label)  # noqa: E731
        tk = [time_ms(lambda: fwd(True), 5, 2)]
        tp = [time_ms(lambda: fwd(False), 5, 2), time_ms(lambda: fwd(False), 5, 2)]
        tk.append(time_ms(lambda: fwd(True), 5, 2))
        log(f"[hires-model] one 512 px forward at batch {HR_B}: kernels "
            f"{sum(tk) / 2:.3f} ms, plain bf16 {sum(tp) / 2:.3f} ms (runs {tk}, {tp})")
    del models, out, ref


def _breakdown(tr, n_imgs, n_iter):
    """Where a library run's time goes: one denoiser forward at the CFG
    batch (host clock around it, and a profile of its device time by
    kernel), the VAE decode and the CLIP encode, each timed alone."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(DEVICE)
    den = tr.cfg.denoiser_cfg
    g = torch.Generator(device="cpu").manual_seed(10)
    x = torch.randn(2 * n_imgs, 4, den.image_size, den.image_size, generator=g).to(dev)
    noise = torch.full((2 * n_imgs, 1), 0.5, device=dev)
    prompts = ["a cute cat"] * n_imgs
    with torch.no_grad():
        label = tr.clip_model.encode_text(prompts + prompts)
        fwd_ms = time_ms(lambda: tr.diffuser.model(x, noise, label), 3, 1)
        vae_ms = time_ms(lambda: tr.vae.decode(x[:n_imgs] * tr._scale_factor), 2, 1)
        clip_ms = time_ms(lambda: tr.clip_model.encode_text(prompts), 3, 1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tr.diffuser.model(x, noise, label)
            torch.cuda.synchronize()
    busy, by_kernel = _device_time(prof)
    px = 8 * den.image_size
    log(f"[hires-breakdown] {px} px, batch {2 * n_imgs}: one denoiser forward {fwd_ms:.3f} ms "
        f"(x {n_iter} calls = {fwd_ms * n_iter / 1e3:.3f} s), VAE decode of {n_imgs} images "
        f"{vae_ms:.3f} ms, CLIP encode {clip_ms:.3f} ms; profiled forward: device busy "
        f"{busy:.3f} ms ({busy / fwd_ms:.1%} of the timed forward); by kernel, us: {by_kernel}")


def _device_us(event):
    return float(getattr(event, "device_time_total", 0.0)
                 or getattr(event, "cuda_time_total", 0.0))


def _device_time(prof, top=14):
    """(device busy ms, the `top` device kernels by time) of a profile:
    the events that ran on the device (kernels, copies), not the host-side
    ops and autograd nodes that carry their children's device time, nor
    user annotations that span them."""
    on_device = torch.autograd.DeviceType.CUDA
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == on_device and _device_us(e) > 0
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: -_device_us(e))
    busy = sum(_device_us(e) for e in rows) / 1e3
    return busy, "; ".join(f"{e.key[:70]} x{e.count} {_device_us(e):.0f}" for e in rows[:top])


def phase_hires_library(cfg, n_imgs, n_iter, smi):
    """DiffusionTransformer on a hi-res deployment: a warm-up run, then a
    timed run of n_imgs images x n_iter DDIM steps (CFG 6) with its exact
    launch counts, images/s and peak memory."""
    from transformer_latent_diffusion_tpu_torch.sampling import DiffusionTransformer

    den = cfg.denoiser_cfg
    t0 = time.perf_counter()
    tr = DiffusionTransformer(cfg, device=DEVICE, seed=0)
    torch.cuda.synchronize()
    log(f"[hires-library] {8 * den.image_size} px DiffusionTransformer built in "
        f"{time.perf_counter() - t0:.1f} s")

    def run():
        return tr.generate_array_from_text("a cute cat", num_imgs=n_imgs, n_iter=n_iter,
                                           sampler="ddim", class_guidance=6)

    # warm-up: the loop's first call runs eagerly, the second captures it
    (_, warm), ((_, capture), held) = _host_s(run), _held_gib(lambda: _host_s(run))
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    imgs = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    px = 8 * den.image_size
    expect = _expect({k: v * den.n_layers * n_iter for k, v in _hires_per_layer(den).items()})
    log(f"[hires-library] {px} px: generate_array_from_text {n_imgs} imgs x {n_iter} DDIM "
        f"steps: {wall:.3f} s ({n_imgs / wall:.3f} imgs/s; warm-up runs: the first "
        f"{warm:.3f} s, eager, the second {capture:.3f} s, the loop's capture, which holds "
        f"{held:.3f} GiB), peak "
        f"memory {peak:.2f} GiB; launches { {k: v for k, v in launches.items() if v} } "
        f"(expected { {k: v for k, v in expect.items() if v} }, no other kernel) | {smi}")
    if imgs.shape != (n_imgs, px, px, 3) or imgs.dtype.name != "uint8" or float(imgs.std()) <= 0:
        raise AssertionError(f"images {imgs.shape} {imgs.dtype}")
    if launches != expect:
        raise AssertionError(f"{px} px launches {launches} != expected {expect}")
    _breakdown(tr, n_imgs, n_iter)
    return tr, launches


# ------------------------------ training (K2) ------------------------------

# one training layer, kernels vs fused_layer_*_plain: rel-L2 of the
# forward's update (as for the serving layer) and of each of the 17
# backward outputs. Measured on an H100 80GB HBM3 at 700 W: forward
# 2.55e-3, worst backward output 3.59e-3 (dcond); about 3x margin.
LAYER_FWD_REL_L2 = 2e-2
LAYER_GRAD_REL_L2 = 1e-2
# one train step's gradients, kernels vs the plain bf16 autograd Denoiser
# (other rounding points: bf16 LayerNorm outputs and hidden state), global
# and worst-leaf rel-L2. Measured on the same card: 0.00294 global, 0.00606
# worst leaf; about 3x margin.
STEP_GRAD_REL_L2 = 1e-2
STEP_GRAD_LEAF_REL_L2 = 2e-2


def _check(name, got, want, tag):
    """Kernel vs plain: rel-L2 and max-abs (relative to max |plain|)."""
    worst = 0.0
    for u, v in zip(got, want):
        r, a, rel_a = _errors(u, v)
        worst = max(worst, a)
        log(f"[{tag}] {name}: rel-L2 {r:.2e} max-abs {a:.3e} ({rel_a:.2e} of max |ref|)")
        if not (r < KERNEL_REL_L2 and rel_a < KERNEL_MAX_ABS):
            raise AssertionError(f"{name} disagrees with its plain version")
    return worst


def _tuple(v):
    return v if isinstance(v, tuple) else (v,)


def phase_train_kernels():
    """Each backward kernel, and the float32 modes of ln_gemm and
    dwconv_gelu that the training layer uses, against their plain
    versions at the flagship layer's shapes at batch TB."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

    dev = torch.device(DEVICE)
    g = torch.Generator(device="cpu").manual_seed(2)
    bf = torch.bfloat16

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * std).to(dev, dtype)

    m = TB * N
    g32 = randn(m, D, std=1e-3)          # upstream gradient (float32)
    glp = g32.to(bf)
    a = randn(m, HIDDEN, dtype=bf)       # GELU output
    h = randn(m, HIDDEN)                 # expanded hidden state
    c = randn(m, HIDDEN)                 # pre-GELU values
    da = randn(m, HIDDEN, std=1e-3)
    dhid = randn(m, HIDDEN, std=1e-3, dtype=bf)
    xn = randn(m, D, dtype=bf)
    x = randn(m, D)
    cond = randn(2 * TB, D, dtype=bf)
    dkv = randn(2 * TB, 2 * D, std=1e-3, dtype=bf)
    dqkv = randn(m, 3 * D, std=1e-3, dtype=bf)
    qkv = randn(m, 3 * D, dtype=bf)
    qc = randn(m, D, dtype=bf)
    kv = randn(2 * TB, 2 * D, dtype=bf)
    dw = randn(9, HIDDEN, std=1 / 3, dtype=bf)
    dwb = randn(HIDDEN, std=0.1)
    b1 = randn(HIDDEN, std=0.1)
    w1 = randn(HIDDEN, D, std=D ** -0.5, dtype=bf)
    w2 = randn(D, HIDDEN, std=HIDDEN ** -0.5, dtype=bf)  # W2 as stored: dX reads it MN-major
    scale = 1.0 + randn(D, std=0.1)

    wg_cases = [(glp, a), (dhid, xn), (glp, xn), (dkv, cond), (dqkv, xn)]
    wg_names = ("dW2", "dW1", "dWq", "dWkv", "dWqkv")
    # a batch of 8 gives 16 conditioning rows: one stage, its rows past M
    # zero-filled by the tensor map
    _check("weight_grad/ragged M", (lv.weight_grad(dkv[:16], cond[:16]),),
           (lv.weight_grad_plain(dkv[:16], cond[:16]),), "train-kernels")
    for name, (u, v) in zip(wg_names, wg_cases):
        _check(f"weight_grad/{name}", (lv.weight_grad(u, v),), (lv.weight_grad_plain(u, v),),
               "train-kernels")
    # the split partials are summed in a fixed order: bit-equal launches
    for name, (u, v) in zip(wg_names, wg_cases):
        if not torch.equal(lv.weight_grad(u, v), lv.weight_grad(u, v)):
            raise AssertionError(f"weight_grad/{name}: two launches on the same inputs differ")
    log(f"[train-kernels] weight_grad: two launches bit-equal for all five; host time per "
        f"call {host_ms(lambda: lv.weight_grad(glp, a)):.4f} ms")
    cases = {  # name: (kernel call, plain call, timed kernel, timed plain)
        "weight_grad": (lambda: lv.weight_grad(glp, a),
                        lambda: lv.weight_grad_plain(glp, a),
                        lambda: [lv.weight_grad(u, v) for u, v in wg_cases],
                        lambda: [lv.weight_grad_plain(u, v) for u, v in wg_cases]),
        "colsum": (lambda: lv.colsum(g32), lambda: lv.colsum_plain(g32),
                   lambda: lv.colsum(g32), lambda: lv.colsum_plain(g32)),
        "layernorm_bwd": (lambda: lv.layernorm_bwd(g32, x, scale, g32),
                          lambda: lv.layernorm_bwd_plain(g32, x, scale, g32),
                          lambda: [lv.layernorm_bwd(g32, x, scale, g32) for _ in range(3)],
                          lambda: [lv.layernorm_bwd_plain(g32, x, scale, g32)
                                   for _ in range(3)]),
        "dwconv_gelu_bwd": (lambda: lv.dwconv_gelu_bwd(da, c, h, dw, HW),
                            lambda: lv.dwconv_gelu_bwd_plain(da, c, h, dw, HW),
                            None, None),
        # dq, dk and dv checked each on its own
        "self_attention_bwd": (lambda: lv.self_attention_bwd(qkv, g32, HEADS, N).split(D, -1),
                               lambda: lv.self_attention_bwd_plain(qkv, g32, HEADS,
                                                                   N).split(D, -1),
                               None, None),
        "cross_attention_bwd": (lambda: lv.cross_attention_bwd(qc, kv, g32, HEADS, N),
                                lambda: lv.cross_attention_bwd_plain(qc, kv, g32, HEADS, N),
                                None, None),
    }
    worst, timed = {}, {}
    for name, (kern, plain, kern_t, plain_t) in cases.items():
        worst[name] = _check(name, _tuple(kern()), _tuple(plain()), "train-kernels")
        timed[name] = (kern_t or kern, plain_t or plain)
    # colsum and dwconv_gelu_bwd: one launch a call each (the kernel sums its
    # own partials, so no colsum follows it), partials added in a fixed
    # order: bit-equal launches, at the db2 shape and at a ragged R
    ragged = g32[:m - 37]
    _check(f"colsum/ragged R = {m - 37}", (lv.colsum(ragged),), (lv.colsum_plain(ragged),),
           "train-kernels")
    _reset_counts()
    lv.colsum(g32)
    lv.dwconv_gelu_bwd(da, c, h, dw, HW)
    _require_launches(_counts(), _expect({"colsum": 1, "dwconv_gelu_bwd": 1}),
                      "one colsum and one dwconv_gelu_bwd call")
    for name, fn in ((f"colsum (db2, {m} x {D})", lambda: lv.colsum(g32)),
                     (f"colsum (ragged R = {m - 37})", lambda: lv.colsum(ragged)),
                     ("dwconv_gelu_bwd (float32, whole grid)",
                      lambda: lv.dwconv_gelu_bwd(da, c, h, dw, HW))):
        _bit_equal_twice(name, fn, "train-kernels")
    _ptxas_report("train-kernels", ("dwconv_gelu_bwd_kernel", "colsum_kernel"))
    del ragged
    # one writer per element and sums in a fixed order: bit-equal launches
    if not torch.equal(lv.self_attention_bwd(qkv, g32, HEADS, N),
                       lv.self_attention_bwd(qkv, g32, HEADS, N)):
        raise AssertionError("self_attention_bwd: two launches on the same inputs differ")
    log(f"[train-kernels] self_attention_bwd: two launches bit-equal; host time per call "
        f"{host_ms(lambda: lv.self_attention_bwd(qkv, g32, HEADS, N)):.4f} ms")
    _ptxas_report("train-kernels", ("self_attention_bwd_kernel",))
    # K1's kernels in the modes only the training layer uses
    _check("ln_gemm/expand float32 out",
           (fs.ln_gemm(xn, w1, bias=b1, out_dtype=torch.float32),),
           (fs.ln_gemm_plain(xn, w1, bias=b1, out_dtype=torch.float32),), "train-kernels")
    _check("ln_gemm/dX = dY W float32 out",
           (fs.ln_gemm(glp, w2, out_dtype=torch.float32, w_transposed=True),),
           (fs.ln_gemm_plain(glp, w2, out_dtype=torch.float32, w_transposed=True),),
           "train-kernels")
    dx_twice = [fs.ln_gemm(glp, w2, out_dtype=torch.float32, w_transposed=True)
                for _ in range(2)]
    if not torch.equal(*dx_twice):
        raise AssertionError("ln_gemm/dX: two launches on the same inputs differ")
    del dx_twice
    log(f"[train-kernels] ln_gemm/dX (W as stored, w_transposed): two launches bit-equal; "
        f"{time_ms(lambda: fs.ln_gemm(glp, w2, out_dtype=torch.float32, w_transposed=True)):.4f}"
        f" ms, F.linear(dY, W^T) {time_ms(lambda: torch.nn.functional.linear(glp, w2.t())):.4f} ms")
    ln = (scale, randn(D, std=0.1))
    _check("ln_gemm/LN rows out", fs.ln_gemm(x, w1[:D].contiguous(), ln=ln, return_xn=True),
           fs.ln_gemm_plain(x, w1[:D].contiguous(), ln=ln, return_xn=True), "train-kernels")
    _check("dwconv_gelu/float32 in, c out", fs.dwconv_gelu(h, dw, dwb, HW, return_c=True),
           fs.dwconv_gelu_plain(h, dw, dwb, HW, return_c=True), "train-kernels")
    _bit_equal_twice("dwconv_gelu/float32 in, c out",
                     lambda: fs.dwconv_gelu(h, dw, dwb, HW, return_c=True), "train-kernels")
    torch.cuda.synchronize()
    timing = time_against_plain(timed, "train-kernels")
    # the attention backwards' yardstick: autograd through SDPA on the same
    # q, k, v and output gradient, the backward alone (as K4's)
    F = torch.nn.functional
    hs = [t.contiguous().requires_grad_(True)
          for t in qkv.reshape(TB, N, 3, HEADS, 64).permute(2, 0, 3, 1, 4)]
    dout = g32.to(bf).reshape(TB, N, HEADS, 64).transpose(1, 2).contiguous()
    out = F.scaled_dot_product_attention(*hs)
    sa_sdpa = time_ms(lambda: torch.autograd.grad(out, hs, dout, retain_graph=True))
    # the same work as self_attention_bwd, which reads the float32 gradient
    # and has no saved log-sum-exp: the gradient rounded to bf16, then the
    # backward through SDPA
    sa_eq = time_ms(lambda: torch.autograd.grad(
        out, hs, g32.to(bf).view(TB, N, HEADS, 64).transpose(1, 2), retain_graph=True))
    kvh = [t.contiguous() for t in kv.reshape(TB, 2, 2, HEADS, 64).permute(2, 0, 3, 1, 4)]
    cs = [qc.reshape(TB, N, HEADS, 64).transpose(1, 2).contiguous().requires_grad_(True),
          *(t.requires_grad_(True) for t in kvh)]
    cout = F.scaled_dot_product_attention(*cs)
    ca_sdpa = time_ms(lambda: torch.autograd.grad(cout, cs, dout, retain_graph=True))
    del hs, out, kvh, cs, cout, dout
    # equal-work yardsticks of the two backwards with no one library call:
    # layernorm_bwd's three calls as three aten LayerNorm backwards (dx,
    # dscale, dbias; the forward's statistics computed beforehand, untimed),
    # and dwconv_gelu_bwd as autograd's backward alone through the same
    # conv (groups = C, with bias) and F.gelu in float32
    lnb = randn(D, std=0.1)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [D], scale, lnb, 1e-5)
    ln_eq = time_ms(lambda: [torch.ops.aten.native_layer_norm_backward(
        g32, x, [D], mean, rstd, scale, lnb, [True, True, True]) for _ in range(3)])
    dw_eq = time_ms(dwb_equal_work(da, h, dw, dwb, HW))
    del mean, rstd
    library = {
        "weight_grad": time_ms(lambda: [u.t() @ v for u, v in wg_cases]),
        "colsum": time_ms(lambda: g32.sum(0)),
        # no one call on the same inputs: PyTorch's LayerNorm backward takes
        # the forward's saved statistics
        "layernorm_bwd": None, "dwconv_gelu_bwd": None,
        "self_attention_bwd": sa_sdpa, "cross_attention_bwd": ca_sdpa,
        "self_attention_bwd (equal work)": sa_eq,
        "layernorm_bwd (equal work)": ln_eq, "dwconv_gelu_bwd (equal work)": dw_eq,
    }
    for name, eq in (("layernorm_bwd", ln_eq), ("dwconv_gelu_bwd", dw_eq)):
        ms = timing[name][0]
        log(f"[train-kernels] {name}: {ms:.4f} ms; equal-work yardstick {eq:.4f} ms: the "
            f"kernel is {'no slower' if ms <= eq else f'{ms / eq:.2f}x slower'}")
    log(f"[train-kernels] library calls (ms): {library}")
    ms = timing["self_attention_bwd"][0]
    log(f"[train-kernels] self_attention_bwd: {ms:.4f} ms; equal-work yardstick (the "
        f"gradient to bf16, then autograd through SDPA's backward) {sa_eq:.4f} ms: the kernel "
        f"is {'no slower' if ms <= sa_eq else f'{ms / sa_eq:.2f}x slower'}")

    def wg_bytes(mm, nn, kk):
        return mm * nn * 2 + mm * kk * 2 + nn * kk * 4

    wg_shapes = [(m, D, HIDDEN), (m, HIDDEN, D), (m, D, D), (2 * TB, 2 * D, D), (m, 3 * D, D)]
    # each product alone: which shape loses
    for name, (u, v), (mm, nn, kk) in zip(wg_names, wg_cases, wg_shapes):
        ms = time_ms(lambda u=u, v=v: lv.weight_grad(u, v))
        lib_ms = time_ms(lambda u=u, v=v: u.t() @ v)
        bnd = bound(wg_bytes(mm, nn, kk), 2 * mm * nn * kk, BF16_TENSOR_FLOP_S)
        log(f"[train-kernels] weight_grad/{name} (M {mm}, N {nn}, K {kk}): {ms:.4f} ms, "
            f"{2 * mm * nn * kk / ms / 1e9:.1f} TFLOP/s; u.t() @ v {lib_ms:.4f} ms; bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})")
    bounds = {
        "weight_grad": bound(sum(wg_bytes(*t) for t in wg_shapes),
                             sum(2 * mm * nn * kk for mm, nn, kk in wg_shapes),
                             BF16_TENSOR_FLOP_S),
        "colsum": bound(m * D * 4 + D * 4, m * D, F32_FLOP_S),
        "layernorm_bwd": bound(3 * (m * D * 16 + D * 4), 3 * 15 * m * D, F32_FLOP_S),
        "dwconv_gelu_bwd": bound(m * HIDDEN * 14 + 9 * HIDDEN * 2 + 11 * HIDDEN * 4,
                                 56 * m * HIDDEN, F32_FLOP_S),
        "self_attention_bwd": bound(m * 3 * D * 4 + m * D * 4,
                                    10 * TB * HEADS * N * N * 64, BF16_TENSOR_FLOP_S),
        "cross_attention_bwd": bound(m * D * 8 + 2 * TB * 2 * D * 4, 10 * m * D, F32_FLOP_S),
    }
    for name, target in (("colsum", 0.040), ("dwconv_gelu_bwd", 0.55)):
        ms = timing[name][0]
        log(f"[train-kernels] {name}: {ms:.4f} ms against its bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]}; {bounds[name][0] / ms:.0%} of it), target {target} ms "
            f"({'met' if ms <= target else 'missed'}); yardstick "
            f"{library[name] if name == 'colsum' else library[name + ' (equal work)']:.4f} ms")
    return worst, timing, library, bounds


def _layer_params(gen, dev):
    """One flagship layer's parameters in PARAM_NAMES order (bf16 weights,
    float32 LayerNorm and biases), requiring gradients."""
    bf = torch.bfloat16

    def p(*shape, std=1.0, dtype=torch.float32, base=0.0):
        t = (base + torch.randn(*shape, generator=gen) * std).to(dev, dtype)
        return t.requires_grad_(True)

    return [p(D, std=0.1, base=1.0), p(D, std=0.1), p(3 * D, D, std=D ** -0.5, dtype=bf),
            p(D, std=0.1, base=1.0), p(D, std=0.1), p(D, D, std=D ** -0.5, dtype=bf),
            p(2 * D, D, std=D ** -0.5, dtype=bf), p(D, std=0.1, base=1.0), p(D, std=0.1),
            p(HIDDEN, D, std=D ** -0.5, dtype=bf), p(HIDDEN, std=0.1),
            p(9, HIDDEN, std=1 / 3, dtype=bf), p(HIDDEN, std=0.1),
            p(D, HIDDEN, std=HIDDEN ** -0.5, dtype=bf), p(D, std=0.1)]


def _reset_counts():
    """Every kernel's launch count to 0, after the device's queued work."""
    torch.cuda.synchronize()
    for mod in _count_modules():
        mod.reset_launch_counts()


def _counts():
    """Every kernel's launches since the last _reset_counts()."""
    torch.cuda.synchronize()
    out = {}
    for mod in _count_modules():
        out.update(mod.LAUNCHES)
    return out


def _expect(nonzero):
    """The launch counts of a run that launched `nonzero` and nothing else."""
    return {**{k: 0 for k in _counts()}, **nonzero}


def phase_train_layer():
    """One decoder layer at batch TB: FusedLayerFunction forward and
    backward against the plain layer forward and backward (all 17
    outputs), its launches per layer, and its times."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

    dev = torch.device(DEVICE)
    gen = torch.Generator(device="cpu").manual_seed(3)
    params = _layer_params(gen, dev)
    bf = torch.bfloat16
    x = torch.randn(TB, N, D, generator=gen).to(dev, bf).requires_grad_(True)
    cond = torch.randn(TB, 2, D, generator=gen).to(dev, bf).requires_grad_(True)
    g = (torch.randn(TB, N, D, generator=gen) * 1e-3).to(dev, bf)
    _reset_counts()
    out = lv.fused_layer(x, cond, params, HEADS, HW)
    out.backward(g)
    per_layer = {k: v for k, v in _counts().items() if v}
    log(f"[train-layer] launches of one layer's forward + backward: {per_layer}")
    # db2 and the three layernorm_bwd partials, one colsum launch each;
    # dwconv_gelu_bwd sums its own partials
    _require_launches({k: per_layer.get(k, 0) for k in ("colsum", "dwconv_gelu_bwd")},
                      {"colsum": 4, "dwconv_gelu_bwd": 1}, "one layer's backward")
    with torch.no_grad():
        want = lv.fused_layer_fwd_plain(x, cond, params, HEADS, HW)
        r = rel_l2(out.float() - x.float(), want.float() - x.float())
        log(f"[train-layer] forward, kernels vs fused_layer_fwd_plain: rel-L2 of the "
            f"layer's update {r:.2e} (bound {LAYER_FWD_REL_L2})")
        if not r < LAYER_FWD_REL_L2:
            raise AssertionError("the training layer's forward disagrees with the plain layer")
        dx, dcond, grads = lv.fused_layer_bwd_plain(x, cond, g, params, HEADS, HW)
    worst = 0.0
    rels = {}
    for name, t, w in zip(("x", "cond") + lv.PARAM_NAMES, [x, cond, *params],
                          [dx, dcond, *grads]):
        rels[name] = rel_l2(t.grad.float(), w.float())
        worst = max(worst, rels[name])
    log("[train-layer] backward, kernels vs fused_layer_bwd_plain, rel-L2 per output: "
        + " ".join(f"{k} {v:.2e}" for k, v in rels.items())
        + f" (worst {worst:.2e}, bound {LAYER_GRAD_REL_L2})")
    if not worst < LAYER_GRAD_REL_L2:
        raise AssertionError("the training layer's gradients disagree with the plain layer")

    detached = [t.detach() for t in params]
    xd, cd = x.detach(), cond.detach()
    timing = time_against_plain({
        "layer forward": (lambda: lv.fused_layer_fwd(xd, cd, detached, HEADS, HW),
                          lambda: lv.fused_layer_fwd_plain(xd, cd, detached, HEADS, HW)),
        "layer backward (with recompute)": (
            lambda: lv.fused_layer_bwd(xd, cd, g, detached, HEADS, HW),
            lambda: lv.fused_layer_bwd_plain(xd, cd, g, detached, HEADS, HW)),
    }, "train-layer")

    def keep_fwd():  # the forward as the backward's recompute runs it
        r = lv._layer_forward(xd, cd, detached, HEADS, HW, keep=True)
        return fs.ln_gemm(r["a"], detached[13], bias=detached[14], residual=r["x2"])

    lean = [time_ms(lambda: lv.fused_layer_fwd(xd, cd, detached, HEADS, HW))]
    keep = [time_ms(keep_fwd), time_ms(keep_fwd)]
    lean.append(time_ms(lambda: lv.fused_layer_fwd(xd, cd, detached, HEADS, HW)))
    keep_ms, lean_ms = sum(keep) / 2, sum(lean) / 2
    n_layers = flagship_configs().denoiser_cfg.n_layers
    log(f"[train-layer] layer forward writing what a backward reads (keep=True, as the "
        f"recompute): {keep_ms:.4f} ms per layer, lean forward (keep=False) {lean_ms:.4f} ms; "
        f"difference {keep_ms - lean_ms:.4f} ms per layer, x {n_layers} layers = "
        f"{(keep_ms - lean_ms) * n_layers:.3f} ms per step (runs keep "
        f"{keep[0]:.4f}/{keep[1]:.4f}, lean {lean[0]:.4f}/{lean[1]:.4f})")
    # the layer's least time: its products at the bf16 tensor peak (the
    # bytes it must move, x, cond, g, the weights and the outputs, are
    # ~0.1 GB, an order less)
    m = TB * N
    products = 2 * m * (3 * D * D + D * D + 2 * HIDDEN * D) + 2 * 2 * TB * 2 * D * D
    attention = 4 * TB * HEADS * N * N * 64
    contract = 2 * m * HIDDEN * D
    fwd = bound(0, products + attention, BF16_TENSOR_FLOP_S)
    # recompute (less the contract product), dX and dW of every product,
    # five attention-backward products
    bwd = bound(0, (products - contract + attention) + 2 * products
                + 10 * TB * HEADS * N * N * 64, BF16_TENSOR_FLOP_S)
    log(f"[train-layer] least time of one layer at batch {TB}: forward {fwd[0]:.3f} ms, "
        f"backward with recompute {bwd[0]:.3f} ms (operations at 989 TFLOP/s)")
    return per_layer, rels, timing


def train_configs(data_dir, **train_kw):
    from transformer_latent_diffusion_tpu_torch.configs import (
        DataConfig,
        ModelConfig,
        TrainConfig,
    )

    cfg = flagship_configs()
    return ModelConfig(
        data_config=DataConfig(*(os.path.join(data_dir, f) for f in
                                 ("latents.npy", "text_emb.npy", "val_emb.npy"))),
        denoiser_config=cfg.denoiser_cfg,
        train_config=TrainConfig(batch_size=TB, n_epoch=1, checkpoint_dir=os.path.join(
            data_dir, "ckpts"), model_name="smoke", **train_kw),
        vae_cfg=cfg.vae_cfg)


def phase_train_step(smi):
    """One train step's gradients at batch TB: the fused layers (kernels)
    against the plain bf16 autograd Denoiser on the same weights and the
    same draws; then ms per step of both and the peak memory."""
    from transformer_latent_diffusion_tpu_torch.configs import TrainConfig
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.train import train as tt
    from transformer_latent_diffusion_tpu_torch.utils.common import init_random_weights_

    dev = torch.device(DEVICE)
    den = flagship_configs().denoiser_cfg
    models = {}
    for fused in (True, False):
        mdl = Denoiser.from_config(den, dtype=torch.bfloat16, fused_layer_vjp=fused)
        models[fused] = init_random_weights_(mdl, 0).to(dev).train()
    gen = torch.Generator(device="cpu").manual_seed(4)
    x = torch.randn(TB, 4, den.image_size, den.image_size, generator=gen).to(dev)
    y = torch.randn(TB, den.text_emb_size, generator=gen).to(dev)
    tc = TrainConfig(batch_size=TB)
    loss_fn = tt.build_loss_fn(models[True], tc, 8.0)
    draws = loss_fn.sample_draws(torch.Generator(device=dev).manual_seed(5), x)
    grads = {}
    for fused, mdl in models.items():
        loss = loss_fn.loss_from_draws(mdl, x, y, **draws)
        loss.backward()
        grads[fused] = {k: p.grad.float() for k, p in mdl.named_parameters()}
        log(f"[train-step] loss ({'kernels' if fused else 'plain bf16'}): {float(loss.detach()):.6f}")
    num = sum(float((grads[True][k] - v).square().sum()) for k, v in grads[False].items())
    den2 = sum(float(v.square().sum()) for v in grads[False].values())
    glob = (num / den2) ** 0.5
    leaf, leaf_name = max((rel_l2(grads[True][k], v), k) for k, v in grads[False].items())
    log(f"[train-step] gradients, kernels vs plain bf16 autograd, same draws: global "
        f"rel-L2 {glob:.5f} (bound {STEP_GRAD_REL_L2}), worst leaf {leaf:.5f} {leaf_name} "
        f"(bound {STEP_GRAD_LEAF_REL_L2})")
    if not (glob < STEP_GRAD_REL_L2 and leaf < STEP_GRAD_LEAF_REL_L2):
        raise AssertionError("the train step's gradients disagree with the plain path")
    del grads

    step_ms = {}
    for fused in (False, True, True, False):
        mdl = models[fused]
        opt, sched = tt.make_optimizer(tc, mdl.parameters())
        state = {"model": mdl, "ema_model": copy.deepcopy(mdl).requires_grad_(False),
                 "optimizer": opt, "scheduler": sched, "step": 0}
        grads_of = tt.make_grads_of(loss_fn)
        sgen = torch.Generator(device=dev).manual_seed(6)
        for _ in range(2):
            tt.train_step(state, grads_of, tc, x, y, sgen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            tt.train_step(state, grads_of, tc, x, y, sgen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms.setdefault(fused, []).append((ms, peak))
        del state, opt, sched
    kern = sum(v[0] for v in step_ms[True]) / 2
    plain = sum(v[0] for v in step_ms[False]) / 2
    peak = max(v[1] for v in step_ms[True])
    log(f"[train-step] flagship 101M, batch {TB}, bf16 compute, float32 master weights, "
        f"Adam + EMA: {kern:.2f} ms/step ({TB / kern * 1e3:.1f} samples/s), peak "
        f"memory {peak:.2f} GiB; plain bf16 autograd {plain:.2f} ms/step (peak "
        f"{max(v[1] for v in step_ms[False]):.2f} GiB); runs {step_ms} | {smi}")
    del models
    torch.cuda.empty_cache()
    return glob, leaf, kern, plain, peak


def phase_train_main(per_layer, smi):
    """train.main at batch TB on random latents: TRAIN_STEPS steps, one
    eval grid through the K1 engine and a checkpoint at step 0, the final
    checkpoint; then a resume that continues the step count. Launch counts
    of both runs against the per-layer counts."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
    from transformer_latent_diffusion_tpu_torch.train import main as train_main

    den = flagship_configs().denoiser_cfg
    n_layers = den.n_layers
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        n = TRAIN_STEPS * TB + TB // 2
        size = (den.n_channels, den.image_size, den.image_size)
        np.save(os.path.join(tmp, "latents.npy"),
                rng.standard_normal((n, *size), dtype=np.float32))
        np.save(os.path.join(tmp, "text_emb.npy"),
                rng.standard_normal((n, den.text_emb_size), dtype=np.float32))
        np.save(os.path.join(tmp, "val_emb.npy"),
                rng.standard_normal((8, den.text_emb_size), dtype=np.float32))
        _reset_counts()
        t0 = time.perf_counter()
        r = train_main(train_configs(tmp, save_and_eval_every_iters=1000), device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        losses = r["losses"]
        steps = r["global_step"]
        expect = {k: v * n_layers * steps for k, v in per_layer.items()}
        for k, v in fs.LAUNCHES_PER_LAYER.items():
            expect[k] = expect.get(k, 0) + v * n_layers * EVAL_CALLS
        expect = {k: v for k, v in expect.items() if v}
        got = {k: v for k, v in launches.items() if v}
        first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
        # the first full-lr Adam step from the seeded init spikes the loss
        # (no warmup), which alone can put first-10 above last-10: also ask
        # that the last 10 end below the untrained loss of step 1, and that
        # the loss still falls from steps 11-15 to steps 16-20
        mid, end = float(np.mean(losses[-10:-5])), float(np.mean(losses[-5:]))
        ckpt = sorted(os.listdir(os.path.join(tmp, "ckpts", "smoke")))
        log(f"[train-main] train.main, batch {TB}, {steps} steps in {wall:.1f} s (eval grid "
            f"and checkpoints included); loss first-10 mean {first:.5f}, last-10 mean "
            f"{last:.5f}, step 1 {losses[0]:.5f}, steps 11-15 mean {mid:.5f}, steps 16-20 "
            f"mean {end:.5f} (per step: {' '.join(f'{v:.3f}' for v in losses)}); "
            f"checkpoints {ckpt}; launches {got} (expected {expect}) | {smi}")
        falls = last < first and last < losses[0] and end < mid
        if steps != TRAIN_STEPS or not all(np.isfinite(losses)) or not falls:
            raise AssertionError(f"train.main: {steps} steps, losses {losses}")
        if got != expect:
            raise AssertionError(f"train.main launches {got} != expected {expect}")
        eval_png = os.path.join(tmp, "ckpts", "smoke", "eval", "emb_val_cfg:4.5_seed:10.png")
        if not os.path.exists(eval_png) or ckpt != ["0", str(steps), "eval"]:
            raise AssertionError(f"eval grid or checkpoints missing: {ckpt}")
        del r
        torch.cuda.empty_cache()

        _reset_counts()
        r2 = train_main(train_configs(tmp, from_scratch=False, save_model=False,
                                      save_and_eval_every_iters=1000), device=DEVICE)
        launches2 = {k: v for k, v in _counts().items() if v}
        expect2 = {k: v * n_layers * TRAIN_STEPS for k, v in per_layer.items()}
        log(f"[train-main] resume (from_scratch=False): step {steps} -> "
            f"{r2['global_step']}, losses finite {all(np.isfinite(r2['losses']))}; "
            f"launches {launches2}")
        if r2["global_step"] != 2 * steps or not all(np.isfinite(r2["losses"])):
            raise AssertionError("the resume did not continue the step count")
        if launches2 != expect2:
            raise AssertionError(f"resume launches {launches2} != expected {expect2}")
    return launches, wall / steps


# ------------------------------ hi-res training (K4, K5's backward) ------------------------------

# one hi-res train step's gradients, kernels vs the plain bf16 autograd
# Denoiser, as the 256 px step (STEP_GRAD_REL_L2, STEP_GRAD_LEAF_REL_L2);
# remat against no remat: the recompute repeats the same kernels on the
# same inputs, so the gradients agree to float32 rounding at most
REMAT_REL_L2 = 1e-5


def _hires_sd(image_size):
    """The 256 px flagship's seeded random weights with the positional
    table upsampled to `image_size` (as hires_config writes them)."""
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.train.highres import (
        upsample_denoiser_params,
    )
    from transformer_latent_diffusion_tpu_torch.utils.common import init_random_weights_

    den = flagship_configs().denoiser_cfg
    sd = init_random_weights_(Denoiser.from_config(den), 0).state_dict()
    return upsample_denoiser_params(sd, den.image_size, image_size, den.patch_size)


def _hires_model(image_size, sd, **flags):
    """The flagship Denoiser at `image_size` on `sd`, bf16 compute, on the
    card, in train mode."""
    import dataclasses

    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser

    den = dataclasses.replace(flagship_configs().denoiser_cfg, image_size=image_size)
    mdl = Denoiser.from_config(den, dtype=torch.bfloat16, **flags)
    mdl.load_state_dict(sd)
    return mdl.to(DEVICE).train()


def phase_hires_train_kernels():
    """K4 (flash_attention_bwd, after the forward with its log-sum-exp) at
    N = 1024 (B = 64), 4096 (B = 2; timed at B = 16 too) and 1536, and K5's
    backward and its row-band dwconv_gelu_bwd at hw = 32 (B = 64), each
    against its plain version; times, bounds, and autograd through SDPA
    as K4's yardstick."""
    from transformer_latent_diffusion_tpu_torch.ops import attention as att
    from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
    from transformer_latent_diffusion_tpu_torch.ops import fused_mlp_vjp as fm

    dev = torch.device(DEVICE)
    g = torch.Generator(device="cpu").manual_seed(12)
    bf = torch.bfloat16
    F = torch.nn.functional

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * std).to(dev, dtype)

    def k4_bound(b, n):
        return bound(7 * b * n * D * 2, 10 * b * HEADS * n * n * 64, BF16_TENSOR_FLOP_S)

    worst, timing, library, bounds = {}, {}, {}, {}
    for b, n, key in ((HT_B, HR_N, "flash_attention_bwd"), (XT_GRAD_B, XR_N, "k4b"),
                      (K4_THIRD_B, K4_THIRD_N, None)):
        qkv = randn(b, n, 3 * D, dtype=bf)
        q, k, v = qkv.chunk(3, dim=-1)  # strided row views, as the model passes them
        gr = randn(b, n, D, std=1e-2, dtype=bf)
        o, lse = att._flash_forward(q, k, v, HEADS, with_lse=True)
        heads = [att._heads(t, HEADS) for t in (q, k, v, gr)]
        kern = lambda: att.flash_attention_bwd(q, k, v, gr, HEADS, o=o, lse=lse)  # noqa: E731
        plain = lambda: att.attention_bwd_plain(*heads)  # noqa: E731
        name = f"flash_attention_bwd B={b} N={n} ({att.attention_bwd_route(n, n, 64)})"
        err = _check(name, kern(), tuple(att._merge(t) for t in plain()), "hires-train-kernels")
        worst["flash_attention_bwd"] = max(worst.get("flash_attention_bwd", 0.0), err)
        if not all(torch.equal(u, w) for u, w in zip(kern(), kern())):
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        log(f"[hires-train-kernels] {name}: two launches bit-equal")
        t = time_against_plain({name: (kern, plain)}, "hires-train-kernels")[name]
        if key is None:
            del qkv, q, k, v, gr, o, lse, heads
            continue
        hs = [h_.contiguous().requires_grad_(True) for h_ in heads[:3]]
        out = F.scaled_dot_product_attention(*hs)
        sdpa = time_ms(lambda: torch.autograd.grad(out, hs, heads[3], retain_graph=True))
        bnd = k4_bound(b, n)
        log(f"[hires-train-kernels] {name}: {t[0]:.4f} ms, "
            f"{10 * b * HEADS * n * n * 64 / t[0] / 1e9:.1f} TFLOP/s; autograd through "
            f"SDPA {sdpa:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})")
        timing[key], library[key], bounds[key] = t, sdpa, bnd
        del qkv, q, k, v, gr, o, lse, heads, hs, out
    # K4b at the 1024 px batch: the kernel alone (the plain version would
    # hold 16 x 12 x 4096^2 float32 scores several times over)
    qkv = randn(XT_B, XR_N, 3 * D, dtype=bf)
    q, k, v = qkv.chunk(3, dim=-1)
    gr = randn(XT_B, XR_N, D, std=1e-2, dtype=bf)
    o, lse = att._flash_forward(q, k, v, HEADS, with_lse=True)
    twice = [att.flash_attention_bwd(q, k, v, gr, HEADS, o=o, lse=lse) for _ in range(2)]
    if not all(torch.equal(u, w) for u, w in zip(*twice)):
        raise AssertionError(f"flash_attention_bwd B={XT_B} N={XR_N}: two launches differ")
    del twice
    ms = time_ms(lambda: att.flash_attention_bwd(q, k, v, gr, HEADS, o=o, lse=lse), 10, 2)
    bnd = k4_bound(XT_B, XR_N)
    hs = [att._heads(t_, HEADS).contiguous().requires_grad_(True) for t_ in (q, k, v)]
    out = F.scaled_dot_product_attention(*hs)
    sdpa = time_ms(lambda: torch.autograd.grad(out, hs, att._heads(gr, HEADS),
                                               retain_graph=True), 10, 2)
    log(f"[hires-train-kernels] flash_attention_bwd B={XT_B} N={XR_N} (k4b, the 1024 px "
        f"step's shape): {ms:.4f} ms, {10 * XT_B * HEADS * XR_N ** 2 * 64 / ms / 1e9:.1f} "
        f"TFLOP/s; autograd through SDPA {sdpa:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}); two "
        f"launches bit-equal")
    del qkv, q, k, v, gr, o, lse, hs, out
    torch.cuda.empty_cache()
    _ptxas_report("hires-train-kernels", ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))

    m = HT_B * HR_N
    x = randn(HT_B, HR_N, D, dtype=bf)
    gr = randn(HT_B, HR_N, D, std=1e-2, dtype=bf)
    w1 = randn(HIDDEN, D, std=D ** -0.5, dtype=bf)
    w2 = randn(D, HIDDEN, std=HIDDEN ** -0.5, dtype=bf)
    b1, dw, dwb = randn(HIDDEN, std=0.1), randn(9, HIDDEN, std=1 / 3, dtype=bf), randn(HIDDEN, std=0.1)
    args = (x, gr, w1, b1, dw, dwb, w2, HR_HW)
    kern = lambda: fm.fused_mlp_sepconv_bwd(*args)  # noqa: E731
    plain = lambda: fm.fused_mlp_sepconv_bwd_plain(*args)  # noqa: E731
    worst["fused_mlp_sepconv_bwd"] = _check("fused_mlp_sepconv_bwd hw=32 (7 outputs)", kern(),
                                            plain(), "hires-train-kernels")
    timing.update(time_against_plain({"fused_mlp_sepconv_bwd": (kern, plain)},
                                     "hires-train-kernels"))
    library["fused_mlp_sepconv_bwd"] = None  # no one call takes these inputs
    library["fused_mlp_sepconv_bwd (equal work)"] = time_ms(
        sepconv_bwd_equal_work(x, gr, w1, b1, dw, dwb, w2, HR_HW), 10, 2)
    log(f"[hires-train-kernels] fused_mlp_sepconv_bwd: equal-work yardstick (autograd's "
        f"backward through F.linear, F.conv2d + F.gelu, F.linear; 7 gradients) "
        f"{library['fused_mlp_sepconv_bwd (equal work)']:.4f} ms")
    # five products of 2 M 768 3072 (the recomputed h, da, dx, dW1, dW2); the
    # bytes: x, g, the weights in, dx and the float32 weight gradients out
    bounds["fused_mlp_sepconv_bwd"] = bound(
        3 * m * D * 2 + 2 * HIDDEN * D * 2 + 9 * HIDDEN * 2 + 2 * HIDDEN * 4
        + 2 * HIDDEN * D * 4 + (11 * HIDDEN + D) * 4, 10 * m * D * HIDDEN, BF16_TENSOR_FLOP_S)
    # what the composition adds against a fused kernel: the float32 h, c
    # and da each written and read once, the bf16 a and dh likewise
    extra = 3 * 2 * m * HIDDEN * 4 + 2 * 2 * m * HIDDEN * 2
    log(f"[hires-train-kernels] fused_mlp_sepconv_bwd: bound "
        f"{bounds['fused_mlp_sepconv_bwd'][0]:.4f} ms ({bounds['fused_mlp_sepconv_bwd'][1]}); "
        f"the composition's own traffic (float32 h, c, da and bf16 a, dh, each written and "
        f"read) {extra / 1e9:.2f} GB = {extra / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s")
    del args, x, gr
    h, c, da = randn(m, HIDDEN), randn(m, HIDDEN), randn(m, HIDDEN, std=1e-3)
    body = lv.dwconv_gelu_bwd_body(HR_HW)
    key = "dwconv_gelu_bwd (row band)"
    worst[key] = _check(f"dwconv_gelu_bwd row bands of {body} hw=32 (4 outputs)",
                        lv.dwconv_gelu_bwd(da, c, h, dw, HR_HW),
                        lv.dwconv_gelu_bwd_plain(da, c, h, dw, HR_HW), "hires-train-kernels")
    _bit_equal_twice(f"dwconv_gelu_bwd row bands of {body} hw=32",
                     lambda: lv.dwconv_gelu_bwd(da, c, h, dw, HR_HW), "hires-train-kernels")
    timing.update(time_against_plain({key: (
        lambda: lv.dwconv_gelu_bwd(da, c, h, dw, HR_HW),
        lambda: lv.dwconv_gelu_bwd_plain(da, c, h, dw, HR_HW))}, "hires-train-kernels"))
    library[key] = time_ms(dwb_equal_work(da, h, dw, dwb, HR_HW), 10, 2)
    bounds[key] = bound(m * HIDDEN * 14 + 9 * HIDDEN * 2 + 11 * HIDDEN * 4, 56 * m * HIDDEN,
                        F32_FLOP_S)
    ms = timing[key][0]
    log(f"[hires-train-kernels] dwconv_gelu_bwd row bands hw=32 B={HT_B}: {ms:.4f} ms, bound "
        f"{bounds[key][0]:.4f} ms ({bounds[key][1]}; {bounds[key][0] / ms:.0%} of it), target "
        f"1.10 ms ({'met' if ms <= 1.10 else 'missed'}); equal-work yardstick (autograd's "
        f"backward through F.conv2d + F.gelu) {library[key]:.4f} ms")
    del h, c, da
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return worst, timing, library, bounds


def _require_launches(got, expect, what):
    if got != expect:
        raise AssertionError(f"{what} launches {got} != expected {expect}")


def _grad_check(models, x, y, train_cfg=None):
    """Global and worst-leaf rel-L2 of models[True]'s gradients against
    models[False]'s on the same batch and draws (of `train_cfg`'s loss,
    TrainConfig() by default)."""
    from transformer_latent_diffusion_tpu_torch.configs import TrainConfig
    from transformer_latent_diffusion_tpu_torch.train import train as tt

    loss_fn = tt.build_loss_fn(models[True], train_cfg or TrainConfig(), 8.0)
    draws = loss_fn.sample_draws(torch.Generator(device=DEVICE).manual_seed(5), x)
    grads = {}
    for key, mdl in models.items():
        loss_fn.loss_from_draws(mdl, x, y, **draws).backward()
        grads[key] = {k: p.grad.float() for k, p in mdl.named_parameters()}
        mdl.zero_grad(set_to_none=True)
    num = sum(float((grads[True][k] - v).square().sum()) for k, v in grads[False].items())
    den2 = sum(float(v.square().sum()) for v in grads[False].values())
    leaf, leaf_name = max((rel_l2(grads[True][k], v), k) for k, v in grads[False].items())
    return (num / den2) ** 0.5, leaf, leaf_name


def _time_steps(mdl, batch, size):
    """ms per step (host clock around 5 steps ending in a synchronise,
    after 2 warm-up steps) and peak GiB of train_step (Adam, EMA) at
    `batch`; the launches of one step; a profile of one more step (device
    busy ms, host ms, the top kernels)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from transformer_latent_diffusion_tpu_torch.configs import TrainConfig
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.train import train as tt

    gen = torch.Generator(device="cpu").manual_seed(13)
    x = torch.randn(batch, 4, size, size, generator=gen).to(DEVICE)
    y = torch.randn(batch, 768, generator=gen).to(DEVICE)
    tc = TrainConfig(batch_size=batch)
    opt, sched = tt.make_optimizer(tc, mdl.parameters())
    den = dataclasses.replace(flagship_configs().denoiser_cfg, image_size=size)
    ema = Denoiser.from_config(den, dtype=torch.bfloat16).to(DEVICE).requires_grad_(False)
    state = {"model": mdl, "ema_model": ema, "optimizer": opt, "scheduler": sched, "step": 0}
    grads_of = tt.make_grads_of(tt.build_loss_fn(mdl, tc, 8.0))
    sgen = torch.Generator(device=DEVICE).manual_seed(6)
    for _ in range(2):
        tt.train_step(state, grads_of, tc, x, y, sgen)
    _reset_counts()
    tt.train_step(state, grads_of, tc, x, y, sgen)
    launches = {k: v for k, v in _counts().items() if v}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        tt.train_step(state, grads_of, tc, x, y, sgen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tt.train_step(state, grads_of, tc, x, y, sgen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, by_kernel = _device_time(prof, 16)
    del state, opt, sched, ema
    return ms, peak, launches, (busy, wall, by_kernel)


def _hires_layer_launches(size, batch):
    """The kernel launches of one flagship decoder block's forward and
    backward on the hi-res component route (fused_layer_vjp and use_pallas
    beyond K2's gate), at `size` and `batch`."""
    from transformer_latent_diffusion_tpu_torch.models.blocks import DecoderBlock

    n = (size // 2) ** 2
    block = DecoderBlock(D, 4, dtype=torch.bfloat16, fused_layer_vjp=True,
                         use_pallas=True).to(DEVICE)
    gen = torch.Generator(device="cpu").manual_seed(14)
    x = torch.randn(batch, n, D, generator=gen).to(DEVICE, torch.bfloat16).requires_grad_(True)
    cond = torch.randn(batch, 2, D, generator=gen).to(DEVICE, torch.bfloat16)
    _reset_counts()
    block(x, cond).float().square().mean().backward()
    launches = {k: v for k, v in _counts().items() if v}
    del block, x
    return launches


def phase_hires_train_step(smi):
    """512 px: one step's gradients (batch HT_GRAD_B) with the kernels
    against the plain bf16 autograd Denoiser, the launches of one block and
    of one step, ms per step and peak memory at batch HT_B. 1024 px:
    remat's gradients against no remat (batch XR_CHECK_B), ms per step,
    peak memory and launches at batch XT_B with remat on (auto from 2048
    tokens)."""
    n_layers = flagship_configs().denoiser_cfg.n_layers
    sd512 = _hires_sd(HT_SIZE)
    models = {True: _hires_model(HT_SIZE, sd512, fused_layer_vjp=True, use_pallas=True),
              False: _hires_model(HT_SIZE, sd512)}
    gen = torch.Generator(device="cpu").manual_seed(15)
    x = torch.randn(HT_GRAD_B, 4, HT_SIZE, HT_SIZE, generator=gen).to(DEVICE)
    y = torch.randn(HT_GRAD_B, 768, generator=gen).to(DEVICE)
    glob, leaf, leaf_name = _grad_check(models, x, y)
    log(f"[hires-train-step] 512 px gradients at batch {HT_GRAD_B}, kernels (K3, K4, K5) vs "
        f"plain bf16 autograd, same draws: global rel-L2 {glob:.5f} (bound {STEP_GRAD_REL_L2}), "
        f"worst leaf {leaf:.5f} {leaf_name} (bound {STEP_GRAD_LEAF_REL_L2})")
    if not (glob < STEP_GRAD_REL_L2 and leaf < STEP_GRAD_LEAF_REL_L2):
        raise AssertionError("the 512 px step's gradients disagree with the plain path")
    del models[False]
    torch.cuda.empty_cache()

    per_layer = _hires_layer_launches(HT_SIZE, HT_B)
    log(f"[hires-train-step] 512 px, one block's forward + backward at batch {HT_B}: {per_layer}")
    # K3 and K5's forward, K4's two kernels, K5's backward (the K1/K2 kernels
    # under them: ln_gemm, dwconv_gelu, weight_grad, colsum, dwconv_gelu_bwd)
    # and nothing of K1's attention or K2's own backward kernels
    calls = {"flash_attention": 1, "flash_attention_bwd": 2, "fused_mlp_sepconv": 1,
             "fused_mlp_sepconv_bwd": 1}
    _require_launches({k: per_layer.get(k, 0) for k in calls}, calls, "512 px block")
    _require_launches(set(per_layer), {*calls, "ln_gemm", "dwconv_gelu", "weight_grad",
                                       "colsum", "dwconv_gelu_bwd"}, "512 px block kernels")
    # K5's backward: db2 in one colsum launch; dwconv_gelu_bwd sums its own partials
    _require_launches({k: per_layer[k] for k in ("colsum", "dwconv_gelu_bwd")},
                      {"colsum": 1, "dwconv_gelu_bwd": 1}, "512 px block's K5 backward")
    ms512, peak512, launches, prof512 = _time_steps(models[True], HT_B, HT_SIZE)
    expect = {k: v * n_layers for k, v in per_layer.items()}
    log(f"[hires-train-step] 512 px flagship, batch {HT_B}, bf16 compute, float32 master "
        f"weights, Adam + EMA: {ms512:.2f} ms/step ({HT_B / ms512 * 1e3:.1f} samples/s), peak "
        f"memory {peak512:.2f} GiB; launches of one step {launches} (expected {expect}) | {smi}")
    _require_launches(launches, expect, "512 px step")
    log(f"[hires-train-step] 512 px profiled step: device busy {prof512[0]:.1f} ms of "
        f"{prof512[1]:.1f} ms ({prof512[0] / prof512[1]:.1%}); by kernel, us: {prof512[2]}")
    del models
    torch.cuda.empty_cache()

    sd1024 = _hires_sd(XT_SIZE)
    gen = torch.Generator(device="cpu").manual_seed(16)
    x = torch.randn(XR_CHECK_B, 4, XT_SIZE, XT_SIZE, generator=gen).to(DEVICE)
    y = torch.randn(XR_CHECK_B, 768, generator=gen).to(DEVICE)
    models = {remat: _hires_model(XT_SIZE, sd1024, fused_layer_vjp=True, use_pallas=True,
                                  remat=remat) for remat in (True, False)}
    glob, leaf, leaf_name = _grad_check(models, x, y)
    log(f"[hires-train-step] 1024 px gradients at batch {XR_CHECK_B}, remat vs no remat: global "
        f"rel-L2 {glob:.2e}, worst leaf {leaf:.2e} {leaf_name} (bound {REMAT_REL_L2})")
    if not leaf < REMAT_REL_L2:
        raise AssertionError("remat's gradients differ from no remat's")
    del models[False]
    torch.cuda.empty_cache()
    ms1024, peak1024, launches1024, prof1024 = _time_steps(models[True], XT_B, XT_SIZE)
    expect = {"flash_attention": 2 * n_layers, "flash_attention_bwd": 2 * n_layers}
    log(f"[hires-train-step] 1024 px flagship, batch {XT_B}, remat: {ms1024:.2f} ms/step "
        f"({XT_B / ms1024 * 1e3:.2f} samples/s), peak memory {peak1024:.2f} GiB; launches of one "
        f"step {launches1024} (expected {expect}: the forward's flash attention again in the "
        f"recompute, no K5 beyond 1024 tokens) | {smi}")
    _require_launches(launches1024, expect, "1024 px step")
    log(f"[hires-train-step] 1024 px profiled step: device busy {prof1024[0]:.1f} ms of "
        f"{prof1024[1]:.1f} ms ({prof1024[0] / prof1024[1]:.1%}); by kernel, us: {prof1024[2]}")
    del models
    torch.cuda.empty_cache()
    return per_layer, launches1024


def _write_latents(path, n, size, seed):
    rng = np.random.default_rng(seed)
    np.save(os.path.join(path, f"latents_{size}.npy"),
            rng.standard_normal((n, 4, size, size), dtype=np.float32))
    np.save(os.path.join(path, f"text_emb_{size}.npy"),
            rng.standard_normal((n, 768), dtype=np.float32))
    return os.path.join(path, f"latents_{size}.npy"), os.path.join(path, f"text_emb_{size}.npy")


def _hires_train_config(tmp, size, n, **train_kw):
    import dataclasses

    from transformer_latent_diffusion_tpu_torch.configs import DataConfig, ModelConfig, TrainConfig

    cfg = flagship_configs()
    lat, emb = _write_latents(tmp, n, size, size)
    val = os.path.join(tmp, "val_emb.npy")
    np.save(val, np.random.default_rng(0).standard_normal((8, 768), dtype=np.float32))
    return ModelConfig(
        data_config=DataConfig(lat, emb, val),
        denoiser_config=dataclasses.replace(cfg.denoiser_cfg, image_size=size),
        train_config=TrainConfig(batch_size=HT_B, n_epoch=1, model_name="ft",
                                 checkpoint_dir=os.path.join(tmp, "ckpts"),
                                 save_and_eval_every_iters=1000, **train_kw),
        vae_cfg=cfg.vae_cfg)


def phase_hires_finetune(per_layer, smi):
    """finetune_highres from the 256 px flagship's seeded weights to a 512
    px config at batch HT_B: FT_STEPS steps, the step-0 eval grid (the EMA
    weights in JAX's eval_model: flash attention, the plain MLP) and
    checkpoints; the loss falls; exact launch counts."""
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.train.highres import finetune_highres
    from transformer_latent_diffusion_tpu_torch.utils.common import init_random_weights_

    den = flagship_configs().denoiser_cfg
    base = init_random_weights_(Denoiser.from_config(den), 0).state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _hires_train_config(tmp, HT_SIZE, FT_STEPS * HT_B)
        _reset_counts()
        t0 = time.perf_counter()
        r = finetune_highres(cfg, base, den.image_size, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _counts().items() if v}
        losses, steps = r["losses"], r["global_step"]
        expect = {k: v * den.n_layers * steps for k, v in per_layer.items()}
        # the eval grid's forwards: flash attention only
        expect["flash_attention"] = expect.get("flash_attention", 0) + den.n_layers * EVAL_CALLS
        first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
        ckpt = sorted(os.listdir(os.path.join(tmp, "ckpts", "ft")))
        log(f"[hires-finetune] finetune_highres 256 -> 512 px, batch {HT_B}, {steps} steps in "
            f"{wall:.1f} s (eval grid and checkpoints included); loss first-4 mean {first:.5f}, "
            f"last-4 mean {last:.5f}, step 1 {losses[0]:.5f} (per step: "
            f"{' '.join(f'{v:.3f}' for v in losses)}); checkpoints {ckpt}; launches {launches} "
            f"(expected {expect}) | {smi}")
        if steps != FT_STEPS or not all(np.isfinite(losses)) or not (
                last < first and last < losses[0]):
            raise AssertionError(f"finetune_highres: {steps} steps, losses {losses}")
        _require_launches(launches, expect, "finetune_highres")
        eval_png = os.path.join(tmp, "ckpts", "ft", "eval", "emb_val_cfg:4.5_seed:10.png")
        if not os.path.exists(eval_png) or ckpt != ["0", str(steps), "eval"]:
            raise AssertionError(f"eval grid or checkpoints missing: {ckpt}")
        del r
    torch.cuda.empty_cache()
    return launches


def phase_multires(per_layer, smi):
    """train.main on a 512 px model with a 256 px bucket (batch HT_B,
    MR_STEPS batches each, interleaved; the 256 px batches add the
    positional table resized onto their 16 x 16 grid): the 1024-token
    batches launch K3, K4 and K5, the 256-token ones K2; exact counts."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
    from transformer_latent_diffusion_tpu_torch.train import main as train_main

    n_layers = flagship_configs().denoiser_cfg.n_layers
    gen = torch.Generator(device="cpu").manual_seed(17)
    params = _layer_params(gen, torch.device(DEVICE))
    x = torch.randn(HT_B, N, D, generator=gen).to(DEVICE, torch.bfloat16).requires_grad_(True)
    cond = torch.randn(HT_B, 2, D, generator=gen).to(DEVICE, torch.bfloat16)
    _reset_counts()
    lv.fused_layer(x, cond, params, HEADS, HW).float().square().mean().backward()
    k2_layer = {k: v for k, v in _counts().items() if v}
    del params, x, cond
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _hires_train_config(tmp, HT_SIZE, MR_STEPS * HT_B, save_model=False)
        lat, emb = _write_latents(tmp, MR_STEPS * HT_B, HT_SIZE // 2, 32)
        cfg.data_config.extra_latent_paths = (lat,)
        cfg.data_config.extra_text_emb_paths = (emb,)
        _reset_counts()
        t0 = time.perf_counter()
        r = train_main(cfg, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _counts().items() if v}
    expect = {}
    for counts in (per_layer, k2_layer):
        for k, v in counts.items():
            expect[k] = expect.get(k, 0) + v * n_layers * MR_STEPS
    expect["flash_attention"] = expect.get("flash_attention", 0) + n_layers * EVAL_CALLS
    losses = r["losses"]
    log(f"[multires] train.main, 512 px model + 256 px bucket, batch {HT_B}: "
        f"{r['global_step']} steps in {wall:.1f} s (step-0 eval grid included); losses "
        f"{' '.join(f'{v:.3f}' for v in losses)}; K2 per layer at batch {HT_B} {k2_layer}; "
        f"launches {launches} (expected {expect}) | {smi}")
    if r["global_step"] != 2 * MR_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"multires: {r['global_step']} steps, losses {losses}")
    _require_launches(launches, expect, "multires")
    del r
    torch.cuda.empty_cache()


# ------------------------------ K6, K8, K9 and the other FFNs ------------------------------

TPU_K6_FWD = "transformer_latent_diffusion_tpu/ops/fused_attn_vjp.py:255"
TPU_K6_BWD = "transformer_latent_diffusion_tpu/ops/fused_attn_vjp.py:276"
TPU_K8 = "transformer_latent_diffusion_tpu/ops/fused_block.py:141"
TPU_K9 = "transformer_latent_diffusion_tpu/ops/fused_block.py:215"
# ragged attention tiles: a 12 x 12 multires bucket and a 200-token grid
# that is not square, at batch 16
RAGGED_NS, RAGGED_B = (144, 200), 16
# the other FFNs' library run (cut from 32 x 50 for time) and train.main
FFN_IMGS, FFN_ITER = 8, 20
FFN_TRAIN_STEPS = 10
# one Denoiser forward with the "mlp" FFN, flash attention (K3) vs the
# plain bf16 forward: the bf16 attention's one-step differences through 12
# layers, as HIRES_MODEL_REL_L2; with the MoE a token whose top-1 expert
# flips between the two (near ties of the float32 router on bf16 LN3
# rows) takes another expert's output, so its bound is looser, and the
# share of flipped (token, layer) routes is bounded on its own. Measured on
# an H100 80GB HBM3 at 700 W (random flagship weights, batch 64): rel-L2
# 0.00900 (mlp) and 0.01607 (moe), 5.59e-3 of the routes flipped; each
# bound leaves about 3x margin
FFN_FWD_REL_L2 = {"mlp": 0.03, "moe": 0.05}
MOE_FLIP_SHARE = 0.02
# one train step's gradients with K6 vs the plain bf16 autograd Denoiser,
# per parameter group (attention pair, FFN, the rest). Measured on the same
# card at batch 128: worst group 0.00300 (mlp); 0.01340 (moe, its FFN, with
# 7.6e-3 of the routes flipped); about 3x margin
FFN_GRAD_REL_L2 = {"mlp": 1e-2, "moe": 0.05}


def _count_modules():
    from transformer_latent_diffusion_tpu_torch.ops import attention as att
    from transformer_latent_diffusion_tpu_torch.ops import fused_attn_vjp as k6
    from transformer_latent_diffusion_tpu_torch.ops import fused_block as fb
    from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
    from transformer_latent_diffusion_tpu_torch.ops import fused_mlp_vjp as fm
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack_f32 as f32
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack_int8 as q8
    from transformer_latent_diffusion_tpu_torch.ops import layer_variants as lvar

    return fs, lv, att, fm, q8, k6, fb, lvar, f32


def _pair_inputs(gen, b, n):
    """x, cond, the upstream gradient and the seven parameters of one
    flagship attention pair (bf16 activations and weights, float32
    LayerNorm), from `gen`."""
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    params = [t.detach() for t in _layer_params(gen, dev)[:7]]
    x = torch.randn(b, n, D, generator=gen).to(dev, bf)
    cond = torch.randn(b, 2, D, generator=gen).to(dev, bf)
    g = (torch.randn(b, n, D, generator=gen) * 1e-3).to(dev, bf)
    return x, cond, g, params


def _pair_flops(b, n):
    """(forward, backward with its recompute) operations of the attention
    pair: the QKV, Q and cond K/V products, the self-attention's two
    products (the 2-key cross-attention's are negligible); the backward
    adds dX and dW of the three products and the five attention-backward
    products."""
    m = b * n
    products = 2 * m * D * 3 * D + 2 * m * D * D + 2 * 2 * b * D * 2 * D
    attention = 4 * b * HEADS * n * n * 64
    fwd = products + attention
    return fwd, fwd + 2 * products + 10 * b * HEADS * n * n * 64


def _sdpa_pair(x, cond, params):
    """The attention pair as F.layer_norm + F.linear + SDPA (a yardstick
    the port never calls)."""
    import torch.nn.functional as F

    ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv = params
    b, n, d = x.shape

    def heads(t):
        return t.reshape(b, -1, HEADS, d // HEADS).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(b, -1, d)

    q, k, v = F.linear(F.layer_norm(x, (d,), ln1s.to(x.dtype), ln1b.to(x.dtype)),
                       wqkv).chunk(3, -1)
    x1 = x + merge(F.scaled_dot_product_attention(heads(q), heads(k), heads(v)))
    qc = F.linear(F.layer_norm(x1, (d,), ln2s.to(x.dtype), ln2b.to(x.dtype)), wq)
    kc, vc = F.linear(cond, wkv).chunk(2, -1)
    return x1 + merge(F.scaled_dot_product_attention(heads(qc), heads(kc), heads(vc)))


def phase_attn_pair_kernels():
    """self_attention and self_attention_bwd on ragged tiles (N = 144,
    200), K6 forward and backward (all nine outputs) at the training
    shapes and on the ragged tiles, K8 and K9 at the 256 px serving shapes,
    each against its plain version; K8's and K9's launches through their
    entry points; times, bounds, and autograd through F.layer_norm +
    F.linear + SDPA beside K6."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_attn_vjp as k6
    from transformer_latent_diffusion_tpu_torch.ops import fused_block as fb
    from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

    tag = "attn-pair-kernels"
    dev = torch.device(DEVICE)
    gen = torch.Generator(device="cpu").manual_seed(8)
    bf = torch.bfloat16
    for n in RAGGED_NS:
        m = RAGGED_B * n
        qkv = torch.randn(m, 3 * D, generator=gen).to(dev, bf)
        res = torch.randn(m, D, generator=gen).to(dev)
        dout = (torch.randn(m, D, generator=gen) * 1e-3).to(dev)
        _check(f"self_attention/N = {n} (the update)",
               (fs.self_attention(qkv, res.clone(), HEADS, n) - res,),
               (fs.self_attention_plain(qkv, res.clone(), HEADS, n) - res,), tag)
        _check(f"self_attention_bwd/N = {n}", (lv.self_attention_bwd(qkv, dout, HEADS, n),),
               (lv.self_attention_bwd_plain(qkv, dout, HEADS, n),), tag)

    names = ("x", "cond") + k6.PARAM_NAMES
    worst = {}
    for b, n in ((TB, N),) + tuple((RAGGED_B, n) for n in RAGGED_NS):
        x, cond, g, params = _pair_inputs(gen, b, n)
        out = k6.fused_attention_pair_fwd(x, cond, *params, HEADS)
        want = k6.fused_attention_pair_fwd_plain(x, cond, *params, HEADS)
        r = rel_l2(out.float() - x.float(), want.float() - x.float())
        err_f = float((out.float() - want.float()).abs().max())
        grads = k6.fused_attention_pair_bwd(x, cond, g, *params, HEADS)
        gwant = k6.fused_attention_pair_bwd_plain(x, cond, g, *params, HEADS)
        rels = {k: rel_l2(u.float(), w.float()) for k, u, w in zip(names, grads, gwant)}
        err_b = max(float((u.float() - w.float()).abs().max()) for u, w in zip(grads, gwant))
        log(f"[{tag}] K6 at B = {b}, N = {n}: forward rel-L2 of the update {r:.2e} (bound "
            f"{LAYER_FWD_REL_L2}), max-abs {err_f:.3e}; backward rel-L2 per output: "
            + " ".join(f"{k} {v:.2e}" for k, v in rels.items())
            + f" (bound {LAYER_GRAD_REL_L2}), max-abs {err_b:.3e}")
        if not (r < LAYER_FWD_REL_L2 and max(rels.values()) < LAYER_GRAD_REL_L2):
            raise AssertionError(f"K6 at N = {n} disagrees with its plain version")
        if n == N:
            worst = {"fused_attention_pair_vjp": err_f, "fused_attention_pair_vjp_bwd": err_b}
            main_case = (x, cond, g, params)
    torch.cuda.synchronize()

    x, cond, g, params = main_case
    timing = time_against_plain({
        "fused_attention_pair_vjp": (
            lambda: k6.fused_attention_pair_fwd(x, cond, *params, HEADS),
            lambda: k6.fused_attention_pair_fwd_plain(x, cond, *params, HEADS)),
        "fused_attention_pair_vjp_bwd": (
            lambda: k6.fused_attention_pair_bwd(x, cond, g, *params, HEADS),
            lambda: k6.fused_attention_pair_bwd_plain(x, cond, g, *params, HEADS)),
    }, tag)
    leaves = [t.clone().requires_grad_(True) for t in (x, cond, *params)]

    def sdpa_fwd_bwd():
        _sdpa_pair(leaves[0], leaves[1], leaves[2:]).backward(g)

    with torch.no_grad():
        sdpa_fwd = time_ms(lambda: _sdpa_pair(x, cond, params))
    sdpa_both = time_ms(sdpa_fwd_bwd)
    fwd_ops, bwd_ops = _pair_flops(TB, N)
    bounds = {"fused_attention_pair_vjp": bound(0, fwd_ops, BF16_TENSOR_FLOP_S),
              "fused_attention_pair_vjp_bwd": bound(0, bwd_ops, BF16_TENSOR_FLOP_S)}
    k_both = timing["fused_attention_pair_vjp"][0] + timing["fused_attention_pair_vjp_bwd"][0]
    log(f"[{tag}] K6 at B = {TB}, N = {N}: forward {timing['fused_attention_pair_vjp'][0]:.4f} "
        f"ms (bound {bounds['fused_attention_pair_vjp'][0]:.4f}, {fwd_ops / 1e9:.1f} GFLOP), "
        f"backward with recompute {timing['fused_attention_pair_vjp_bwd'][0]:.4f} ms (bound "
        f"{bounds['fused_attention_pair_vjp_bwd'][0]:.4f}, {bwd_ops / 1e9:.1f} GFLOP), both "
        f"{k_both:.4f} ms; yardstick, autograd through F.layer_norm + F.linear + SDPA: "
        f"forward {sdpa_fwd:.4f} ms, forward + backward {sdpa_both:.4f} ms")

    # K8 and K9 at the 256 px serving shapes, through their entry points
    x8, cond8, _, p8 = _pair_inputs(gen, B, N)
    kc, vc = (torch.randn(B, 2, D, generator=gen).to(dev, bf) for _ in range(2))
    k8 = (x8, *p8[:5], p8[5], kc, vc)
    lp = [t.detach() for t in _layer_params(gen, dev)]
    k9 = (x8, lp[7], lp[8], lp[9], lp[10], lp[11], lp[12], lp[13], lp[14])
    _reset_counts()
    out8 = fb.fused_attention_pair(*k8, HEADS)
    out9 = fb.fused_mlp_sepconv(*k9, HW)
    launches = {k: v for k, v in _counts().items() if v}
    expect = {"fused_block.fused_attention_pair": 1, "fused_block.fused_mlp_sepconv": 1,
              "ln_gemm": 4, "self_attention": 1, "cross_attention": 1, "dwconv_gelu": 1}
    log(f"[{tag}] K8 and K9 through their entry points at batch {B}: launches {launches} "
        f"(expected {expect})")
    _require_launches(launches, expect, "K8/K9")
    xf = x8.float()
    for name, got, want in (
            ("fused_block.fused_attention_pair", out8, fb.fused_attention_pair_plain(*k8, HEADS)),
            ("fused_block.fused_mlp_sepconv", out9, fb.fused_mlp_sepconv_plain(*k9, HW))):
        r = rel_l2(got.float() - xf, want.float() - xf)
        worst[name] = float((got.float() - want.float()).abs().max())
        log(f"[{tag}] {name}: rel-L2 of the update {r:.2e} (bound {LAYER_FWD_REL_L2}), "
            f"max-abs {worst[name]:.3e}")
        if not r < LAYER_FWD_REL_L2:
            raise AssertionError(f"{name} disagrees with its plain version")
    timing.update(time_against_plain({
        "fused_block.fused_attention_pair": (lambda: fb.fused_attention_pair(*k8, HEADS),
                                             lambda: fb.fused_attention_pair_plain(*k8, HEADS)),
        "fused_block.fused_mlp_sepconv": (lambda: fb.fused_mlp_sepconv(*k9, HW),
                                          lambda: fb.fused_mlp_sepconv_plain(*k9, HW)),
    }, tag))
    m = B * N
    bounds["fused_block.fused_attention_pair"] = bound(
        0, 2 * m * D * 4 * D + 4 * B * HEADS * N * N * 64, BF16_TENSOR_FLOP_S)
    bounds["fused_block.fused_mlp_sepconv"] = bound(
        0, 4 * m * D * HIDDEN, BF16_TENSOR_FLOP_S)
    log(f"[{tag}] least times: "
        + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in bounds.items()))
    library = dict.fromkeys(bounds)  # no one PyTorch call computes any of them
    library["fused_block.fused_attention_pair (equal work)"] = time_ms(pair_equal_work(*k8, HEADS))
    library["fused_block.fused_mlp_sepconv (equal work)"] = time_ms(sepconv_equal_work(
        x8, *k9[3:], HW, ln=k9[1:3]))
    log(f"[{tag}] equal-work yardsticks in PyTorch calls (bf16): K8 (F.layer_norm, F.linear, "
        f"SDPA, twice) {library['fused_block.fused_attention_pair (equal work)']:.4f} ms, K9 "
        f"(F.layer_norm, F.linear, F.conv2d + F.gelu, F.linear, + x) "
        f"{library['fused_block.fused_mlp_sepconv (equal work)']:.4f} ms")
    return worst, timing, library, bounds, launches


def ffn_config(mlp_class):
    """The flagship deployment with the "mlp" or "moe" FFN (the MoE with the
    JAX defaults: 8 experts, capacity factor 1.25)."""
    cfg = flagship_configs()
    return dataclasses.replace(cfg, denoiser_cfg=dataclasses.replace(
        cfg.denoiser_cfg, mlp_class=mlp_class))


def _route_recorder(model):
    """Forward hooks that keep each MoE block's top-1 expert per token, in
    call order (empty for the other FFNs)."""
    routes = []
    for blk in model.denoiser_trans_block.decoder_blocks:
        if blk.mlp_class == "moe":
            blk.mlp.register_forward_hook(
                lambda mod, inp, out: routes.append(mod.route(inp[0])[3].argmax(-1)))
    return routes


def _flip_share(a, b):
    """The share of (token, layer) routes that differ between two runs."""
    if not a:
        return 0.0
    return float(sum(int((u != v).sum()) for u, v in zip(a, b))
                 / sum(u.numel() for u in a))


def phase_ffn_serving(mlp_class, smi):
    """DiffusionTransformer on the flagship with the "mlp" or "moe" FFN:
    no fused engine, so the linen path with flash attention (K3); one
    Denoiser forward at batch B against the plain bf16 forward, a library
    run (FFN_IMGS x FFN_ITER DDIM steps, CFG 6) with exact launch counts,
    the WSGI service."""
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.sampling import DiffusionTransformer
    from transformer_latent_diffusion_tpu_torch.serve.app import GenerationService

    tag = f"{mlp_class}-serving"
    cfg = ffn_config(mlp_class)
    den = cfg.denoiser_cfg
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    tr = DiffusionTransformer(cfg, device=DEVICE, seed=0)
    torch.cuda.synchronize()
    log(f"[{tag}] DiffusionTransformer built in {time.perf_counter() - t0:.1f} s, fused "
        f"engine: {tr.diffuser.fast_apply}")
    if tr.diffuser.fast_apply is not None:
        raise AssertionError(f"a {mlp_class} deployment built a fused engine")
    model = tr.diffuser.model
    plain = Denoiser.from_config(den, dtype=torch.bfloat16)
    plain.load_state_dict(model.state_dict())
    plain.to(dev).eval()
    g = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn(B, 4, den.image_size, den.image_size, generator=g).to(dev)
    noise = torch.rand(B, 1, generator=g).to(dev)
    label = torch.randn(B, den.text_emb_size, generator=g).to(dev)
    routes_k, routes_p = _route_recorder(model), _route_recorder(plain)
    with torch.no_grad():
        _reset_counts()
        out = model(x, noise, label)
        launches = {k: v for k, v in _counts().items() if v}
        ref = plain(x, noise, label)
    torch.cuda.synchronize()
    flips = _flip_share(routes_k, routes_p)
    routes_k.clear(), routes_p.clear()
    r = rel_l2(out, ref)
    cos = float(torch.nn.functional.cosine_similarity(
        out.double().flatten(), ref.double().flatten(), dim=0))
    expect = {"flash_attention": den.n_layers}
    log(f"[{tag}] Denoiser forward, flash attention vs the plain bf16 forward, batch {B}: "
        f"rel-L2 {r:.5f} (bound {FFN_FWD_REL_L2[mlp_class]}), cos {cos:.6f}; MoE routes "
        f"that differ: {flips:.2e} of (token, layer) (bound {MOE_FLIP_SHARE}); launches "
        f"{launches} (expected {expect})")
    if not (torch.isfinite(out).all() and r < FFN_FWD_REL_L2[mlp_class]
            and flips < MOE_FLIP_SHARE):
        raise AssertionError(f"the {mlp_class} forward disagrees with the plain forward")
    _require_launches(launches, expect, f"{mlp_class} forward")
    with torch.no_grad():
        tk = [time_ms(lambda: model(x, noise, label), 5, 2)]
        tp = [time_ms(lambda: plain(x, noise, label), 5, 2) for _ in range(2)]
        tk.append(time_ms(lambda: model(x, noise, label), 5, 2))
    log(f"[{tag}] one forward at batch {B}: {sum(tk) / 2:.3f} ms (flash attention), plain "
        f"{sum(tp) / 2:.3f} ms (runs {tk}, {tp})")
    del plain

    def run():
        return tr.generate_array_from_text("a cute cat", num_imgs=FFN_IMGS, n_iter=FFN_ITER,
                                           sampler="ddim", class_guidance=6)

    run()  # warm-up: the loop's first call runs eagerly,
    run()  # the second captures it
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    imgs = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect = _expect({"flash_attention": den.n_layers * FFN_ITER})
    px = 8 * den.image_size
    log(f"[{tag}] generate_array_from_text {FFN_IMGS} imgs x {FFN_ITER} DDIM steps: "
        f"{wall:.3f} s ({FFN_IMGS / wall:.3f} imgs/s), peak memory {peak:.2f} GiB; launches "
        f"{ {k: v for k, v in launches.items() if v} } (expected flash_attention "
        f"{expect['flash_attention']} only, no K1) | {smi}")
    if imgs.shape != (FFN_IMGS, px, px, 3) or imgs.dtype.name != "uint8" or float(imgs.std()) <= 0:
        raise AssertionError(f"images {imgs.shape} {imgs.dtype}")
    _require_launches(launches, expect, f"{mlp_class} library")
    phase_serving(GenerationService(transformer=tr), tag)
    del tr, model
    torch.cuda.empty_cache()


def _param_groups(names):
    """Parameter name -> group: the attention pair (K6's seven), the FFN
    (norm3 and mlp.*), the rest (embeddings, out projection)."""
    def group(k):
        if ".decoder_blocks." not in k:
            return "rest"
        leaf = k.split(".decoder_blocks.")[1].split(".", 1)[1]
        return "ffn" if leaf.startswith(("mlp.", "norm3.")) else "attention pair"

    return {k: group(k) for k in names}


def phase_ffn_train(mlp_class, smi):
    """Training with the "mlp" or "moe" FFN at batch TB: one step's
    gradients with K6 (the JAX gate: K2 does not take these FFNs) against
    the plain bf16 autograd Denoiser on the same weights and draws (cosine
    and rel-L2 per parameter group), ms per step and peak memory of both,
    then train.main for FFN_TRAIN_STEPS steps with exact launch counts.
    Returns train.main's launches."""
    from transformer_latent_diffusion_tpu_torch.configs import DataConfig, ModelConfig, TrainConfig
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.train import main as train_main
    from transformer_latent_diffusion_tpu_torch.train import train as tt
    from transformer_latent_diffusion_tpu_torch.utils.common import init_random_weights_

    tag = f"{mlp_class}-train"
    dev = torch.device(DEVICE)
    cfg = ffn_config(mlp_class)
    den = cfg.denoiser_cfg
    models = {}
    for fused in (True, False):
        mdl = Denoiser.from_config(den, dtype=torch.bfloat16, fused_layer_vjp=fused,
                                   use_pallas=fused)
        models[fused] = init_random_weights_(mdl, 0).to(dev).train()
    gen = torch.Generator(device="cpu").manual_seed(10)
    x = torch.randn(TB, 4, den.image_size, den.image_size, generator=gen).to(dev)
    y = torch.randn(TB, den.text_emb_size, generator=gen).to(dev)
    tc = TrainConfig(batch_size=TB)
    loss_fn = tt.build_loss_fn(models[True], tc, 8.0)
    draws = loss_fn.sample_draws(torch.Generator(device=dev).manual_seed(11), x)
    grads, routes, losses = {}, {}, {}
    for fused, mdl in models.items():
        routes[fused] = _route_recorder(mdl)
        _reset_counts()
        loss = loss_fn.loss_from_draws(mdl, x, y, **draws)
        loss.backward()
        if fused:
            per_step = {k: v for k, v in _counts().items() if v}
        losses[fused] = float(loss.detach())
        grads[fused] = {k: p.grad.float() for k, p in mdl.named_parameters()}
    flips = _flip_share(routes[True], routes[False])
    groups = _param_groups(grads[False])
    stats = {}
    for name in sorted(set(groups.values())):
        keys = [k for k, v in groups.items() if v == name]
        u = torch.cat([grads[True][k].flatten() for k in keys]).double()
        w = torch.cat([grads[False][k].flatten() for k in keys]).double()
        stats[name] = (float((u - w).norm() / w.norm()),
                       float(torch.nn.functional.cosine_similarity(u, w, dim=0)))
    del grads
    log(f"[{tag}] loss kernels {losses[True]:.6f}, plain bf16 {losses[False]:.6f}; "
        f"gradients, K6 vs plain bf16 autograd, same draws, per group (rel-L2, cosine): "
        + "; ".join(f"{k} {v[0]:.5f}, {v[1]:.6f}" for k, v in stats.items())
        + f" (bound {FFN_GRAD_REL_L2[mlp_class]}); MoE routes that differ {flips:.2e}; "
        f"launches of the step {per_step}")
    if not all(v[0] < FFN_GRAD_REL_L2[mlp_class] for v in stats.values()):
        raise AssertionError(f"the {mlp_class} step's gradients disagree with the plain path")
    # K6 in every layer, forward and backward; no flash attention, and none
    # of K2's MLP kernels
    watch = {"fused_attention_pair_vjp": den.n_layers,
             "fused_attention_pair_vjp_bwd": den.n_layers, "flash_attention": 0,
             "dwconv_gelu": 0, "dwconv_gelu_bwd": 0}
    _require_launches({k: per_step.get(k, 0) for k in watch}, watch, f"the {mlp_class} step")

    step_ms = {}
    for fused in (False, True, True, False):
        mdl = models[fused]
        opt, sched = tt.make_optimizer(tc, mdl.parameters())
        state = {"model": mdl, "ema_model": copy.deepcopy(mdl).requires_grad_(False),
                 "optimizer": opt, "scheduler": sched, "step": 0}
        grads_of = tt.make_grads_of(loss_fn)
        sgen = torch.Generator(device=dev).manual_seed(12)
        for _ in range(2):
            tt.train_step(state, grads_of, tc, x, y, sgen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            tt.train_step(state, grads_of, tc, x, y, sgen)
        torch.cuda.synchronize()
        step_ms.setdefault(fused, []).append(((time.perf_counter() - t0) / 5 * 1e3,
                                              torch.cuda.max_memory_allocated() / 2 ** 30))
        del state, opt, sched
    kern = sum(v[0] for v in step_ms[True]) / 2
    plain = sum(v[0] for v in step_ms[False]) / 2
    log(f"[{tag}] flagship, {mlp_class} FFN, batch {TB}, bf16 compute, float32 master "
        f"weights, Adam + EMA: {kern:.2f} ms/step ({TB / kern * 1e3:.1f} samples/s), peak "
        f"memory {max(v[1] for v in step_ms[True]):.2f} GiB; plain bf16 autograd "
        f"{plain:.2f} ms/step (peak {max(v[1] for v in step_ms[False]):.2f} GiB); runs "
        f"{step_ms} | {smi}")
    del models
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(1)
        n = FFN_TRAIN_STEPS * TB + TB // 2
        size = (den.n_channels, den.image_size, den.image_size)
        paths = [os.path.join(tmp, f) for f in ("latents.npy", "text_emb.npy", "val_emb.npy")]
        np.save(paths[0], rng.standard_normal((n, *size), dtype=np.float32))
        np.save(paths[1], rng.standard_normal((n, den.text_emb_size), dtype=np.float32))
        np.save(paths[2], rng.standard_normal((8, den.text_emb_size), dtype=np.float32))
        mcfg = ModelConfig(
            data_config=DataConfig(*paths), denoiser_config=den,
            train_config=TrainConfig(batch_size=TB, n_epoch=1, save_model=False,
                                     save_and_eval_every_iters=1000,
                                     checkpoint_dir=os.path.join(tmp, "ckpts")),
            vae_cfg=cfg.vae_cfg)
        _reset_counts()
        t0 = time.perf_counter()
        r = train_main(mcfg, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
    steps, losses = r["global_step"], r["losses"]
    expect = {k: v * steps for k, v in per_step.items()}
    expect["flash_attention"] = den.n_layers * EVAL_CALLS  # the step-0 eval grid
    expect = _expect(expect)
    got = {k: v for k, v in launches.items() if v}
    aux = load = None
    if mlp_class == "moe":
        model = r["model"]
        aux = float(model.moe_aux_loss().detach())
        load = [round(float(v), 4) for v in model.denoiser_trans_block.decoder_blocks[-1].mlp.load]
    tail = float(np.mean(losses[-3:]))
    log(f"[{tag}] train.main, batch {TB}, {steps} steps in {wall:.1f} s (one eval grid "
        f"through flash attention included); losses {' '.join(f'{v:.3f}' for v in losses)}; "
        f"last-3 mean {tail:.4f}; Switch loss of the last step {aux} ({den.n_layers} "
        f"layers, each in [1, {den.n_experts}]), last layer's expert load {load}; launches "
        f"{got} (expected "
        f"{ {k: v for k, v in expect.items() if v} })")
    falls = tail < losses[0] and tail < max(losses[:5])
    if steps != FFN_TRAIN_STEPS or not all(np.isfinite(losses)) or not falls:
        raise AssertionError(f"{mlp_class} train.main: {steps} steps, losses {losses}")
    n_l = den.n_layers
    if aux is not None and not (np.isfinite(aux) and n_l * (1 - 1e-3) <= aux
                                <= n_l * den.n_experts):
        raise AssertionError(f"the Switch loss {aux} is out of [{n_l}, "
                             f"{n_l * den.n_experts}]")
    _require_launches(launches, expect, f"{mlp_class} train.main")
    del r
    torch.cuda.empty_cache()
    return launches, kern, plain


# ------------------------------ the probes S3, S2, S4 ------------------------------

TPU_S1 = "scripts/microbench_int8.py:74"
TPU_S2 = "scripts/probe_train_bwd_stage.py:259"
TPU_S3 = "scripts/probe_attn_softmax.py:55"
TPU_S4 = "scripts/microbench_layer.py:252"
# the probes' own shapes: S3 at B = 4, 12 heads, 4096 tokens; S2 and S4 at
# batch 256 of the flagship layer (256 tokens)
S3_B, S3_N = 4, 4096
S2_B = S4_B = 256
# the plain versions' timings take this many calls (they are references,
# and the whole-layer ones take 50-300 ms a call at these shapes)
PLAIN_REPS = 3


def _check_rows(tag, cases):
    """{name: (check kernel, check plain, time kernel, time plain, (bound
    ms, bound by), library call or None)}: each kernel call's outputs
    against its plain version's (every output not None, rel-L2 <
    KERNEL_REL_L2 and max-abs < KERNEL_MAX_ABS of the plain output's
    scale), then times taken plain, kernel, kernel, plain, and the library
    call's. Returns {name: row of the kernels line, without launches}."""
    from transformer_latent_diffusion_tpu_torch.scripts import _probe

    dev = torch.device(DEVICE)
    rows = {}
    for name, (kern, plain, kern_t, plain_t, bnd, lib) in cases.items():
        with torch.no_grad():
            got, want = _tuple(kern()), _tuple(plain())
            torch.cuda.synchronize()
            worst_r = worst_rel = worst_a = 0.0
            for u, w in zip(got, want):
                if (u is None) != (w is None):
                    raise AssertionError(f"{name}: the kernel path and the plain version "
                                         f"compute different outputs")
                if u is None:
                    continue
                r, a, rel_a = _errors(u, w)
                worst_r, worst_a, worst_rel = max(worst_r, r), max(worst_a, a), max(worst_rel, rel_a)
            del got, want
            ok = worst_r < KERNEL_REL_L2 and worst_rel < KERNEL_MAX_ABS
            kms, pms = _probe.time_against_plain(kern_t, plain_t, dev, 20, PLAIN_REPS)
            lms = time_ms(lib) if lib is not None else None
        log(f"[{tag}] {name}: rel-L2 {worst_r:.2e} max-abs {worst_a:.3e} ({worst_rel:.2e} of "
            f"max |ref|; bounds {KERNEL_REL_L2}, {KERNEL_MAX_ABS}); {kms:.4f} ms, plain "
            f"{pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), library "
            f"{'none' if lms is None else f'{lms:.4f} ms'}")
        if not ok:
            raise AssertionError(f"{tag} {name} disagrees with its plain version")
        rows[name] = {"max_abs_err": worst_a, "ms": kms, "plain_ms": pms, "bound_ms": bnd[0],
                      "bound_by": bnd[1], "library_ms": lms}
        torch.cuda.empty_cache()
    return rows


def _line_rows(rows, tpu, label, source, launches):
    """Rows of the kernels line from `_check_rows`'s: `label(name)` and
    `source(name)` name each, `launches(name)` its launches in the
    probe's run."""
    port = "transformer_latent_diffusion_tpu_torch"
    return [{"name": label(name), "route": "cuda", "source": f"{port}/{source(name)}",
             "replaces": tpu, "launches": launches(name), **row}
            for name, row in rows.items()]


def _nbytes(*tensors):
    """Bytes of the tensors (None skipped, lists flattened)."""
    total = 0
    for t in tensors:
        if isinstance(t, (list, tuple)):
            total += _nbytes(*t)
        elif t is not None:
            total += t.numel() * t.element_size()
    return total


def phase_s3():
    """S3 (scripts/probe_attn_softmax.py) through its entry point at its
    shapes (B = 4, 12 heads, N = 4096; with each form's compiled
    instruction counts), its launches; then each softmax form's kernel
    against its plain version, with SDPA on the same q, k, v as the
    library call, and how far prediv (the TPU K3's rounding) lands from
    K3's own form."""
    from transformer_latent_diffusion_tpu_torch.scripts import probe_attn_softmax as s3

    F = torch.nn.functional
    _reset_counts()
    res = s3.main(["--batch", str(S3_B), "--heads", str(HEADS), "--tokens", str(S3_N),
                   "--device", DEVICE, "--sass"])
    _require_launches(_counts(), _expect({"flash_attention_variant": sum(
        sum(r["launches"].values()) for r in res["variants"].values())}), "s3")
    q, k, v = res["inputs"]
    b, h, n, dh = q.shape
    bnd = bound(4 * _nbytes(q), 4 * b * h * n * n * dh, BF16_TENSOR_FLOP_S)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    cases = {}
    for tag, r in res["variants"].items():
        e2, pd = r["use_exp2"], r["postdiv"]
        cases[tag] = (lambda e2=e2, pd=pd: s3.attn(q, k, v, e2, pd),
                      lambda e2=e2, pd=pd: s3.attn_plain(q, k, v, e2, pd),
                      lambda e2=e2, pd=pd: s3.attn(q, k, v, e2, pd),
                      lambda e2=e2, pd=pd: s3.attn_plain(q, k, v, e2, pd), bnd, sdpa)
    rows = _check_rows("s3", cases)
    outs = {tag: r["out"].float() for tag, r in res["variants"].items()}
    k3 = outs["exp2,postdiv (K3)"]
    r, a, rel_a = _errors(outs["exp,prediv"], k3)
    log(f"[s3] prediv (the TPU K3's rounding) against K3's postdiv form: rel-L2 {r:.2e}, "
        f"max-abs {a:.3e} ({rel_a:.2e} of max |K3|)")
    launches = {tag: sum(r["launches"].values()) for tag, r in res["variants"].items()}
    del res, outs, k3
    torch.cuda.empty_cache()
    return _line_rows(rows, TPU_S3, "flash_attention_variant ({})".format,
                      lambda _: "csrc/flash_attention.cu", launches.get)


def phase_s2():
    """S2 (scripts/probe_train_bwd_stage.py) through its entry point at
    batch 256: the forward and the six backward modes timed, the shares of
    the backward, bwd/fwd; each mode's outputs against its written-out
    plain version; then the bf16 modes of the kernels that bf16res runs
    (dwconv_gelu writing a bf16 c from bf16 h, layernorm_bwd reading a bf16
    x, dwconv_gelu_bwd reading bf16 c and h) at its shapes, dwconv_gelu's and
    dwconv_gelu_bwd's bf16 modes bit-equal across two launches, and ptxas's
    registers and spills of dwconv_gelu's TMA body."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
    from transformer_latent_diffusion_tpu_torch.scripts import probe_train_bwd_stage as s2

    _reset_counts()
    res = s2.main(["--batch", str(S2_B), "--device", DEVICE])
    log(f"[s2] launches of the probe's run: { {k: v for k, v in _counts().items() if v} }")
    x, cond, g, params = res["inputs"]
    flops = {k: v * S2_B for k, v in res["flops"].items()}
    work = {"full": flops["full"], "bf16res": flops["full"],
            "recompute": flops["recompute"], "no_mlp": flops["full"] - flops["mlp"],
            "no_cross": flops["full"] - flops["cross"], "no_self": flops["full"] - flops["self"]}
    cases = {}
    for mode, r in res["modes"].items():
        bnd = bound(_nbytes(x, cond, g, params, r["out"]), work[mode], BF16_TENSOR_FLOP_S)

        def kern(m=mode):
            dx, dcond, grads = lv.fused_layer_bwd_variant(m, x, cond, g, params, HEADS, HW)
            return (dx, dcond, *grads)

        def plain(m=mode):
            dx, dcond, grads = lv.fused_layer_bwd_variant_plain(m, x, cond, g, params,
                                                                 HEADS, HW)
            return (dx, dcond, *grads)

        cases[mode] = (kern, plain, kern, plain, bnd, None)
    rows = _line_rows(_check_rows("s2", cases), TPU_S2, "fused_layer_bwd_variant ({})".format,
                      lambda _: "ops/fused_layer_vjp.py",
                      lambda m: sum(res["modes"][m]["launches"].values()))
    bf16res = res["modes"]["bf16res"]["launches"]
    del res

    # the bf16 modes of three kernels, at the probe's shapes
    dev = torch.device(DEVICE)
    gen = torch.Generator(device="cpu").manual_seed(72)
    bf = torch.bfloat16
    m = S2_B * N

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * std).to(dev, dtype)

    h, dw, dwb = randn(m, HIDDEN, dtype=bf), randn(9, HIDDEN, std=1 / 3, dtype=bf), randn(HIDDEN)
    c, da = randn(m, HIDDEN, dtype=bf), randn(m, HIDDEN)
    dy, xb, up, sc = randn(m, D), randn(m, D, dtype=bf), randn(m, D), 1 + randn(D, std=0.1)
    kcases = {
        "dwconv_gelu (bf16 c)": (
            lambda: fs.dwconv_gelu(h, dw, dwb, HW, return_c=True, c_dtype=bf),
            lambda: fs.dwconv_gelu_plain(h, dw, dwb, HW, return_c=True, c_dtype=bf),
            lambda: fs.dwconv_gelu(h, dw, dwb, HW, return_c=True, c_dtype=bf),
            lambda: fs.dwconv_gelu_plain(h, dw, dwb, HW, return_c=True, c_dtype=bf),
            bound(m * HIDDEN * 6 + 9 * HIDDEN * 2 + HIDDEN * 4, 26 * m * HIDDEN, F32_FLOP_S),
            None),
        "layernorm_bwd (bf16 x)": (
            lambda: lv.layernorm_bwd(dy, xb, sc, up), lambda: lv.layernorm_bwd_plain(dy, xb, sc, up),
            lambda: lv.layernorm_bwd(dy, xb, sc, up), lambda: lv.layernorm_bwd_plain(dy, xb, sc, up),
            bound(m * D * 14 + 3 * D * 4, 15 * m * D, F32_FLOP_S), None),
        "dwconv_gelu_bwd (bf16 c, h)": (
            lambda: lv.dwconv_gelu_bwd(da, c, h, dw, HW),
            lambda: lv.dwconv_gelu_bwd_plain(da, c, h, dw, HW),
            lambda: lv.dwconv_gelu_bwd(da, c, h, dw, HW),
            lambda: lv.dwconv_gelu_bwd_plain(da, c, h, dw, HW),
            bound(m * HIDDEN * 10 + 9 * HIDDEN * 2 + 11 * HIDDEN * 4, 40 * m * HIDDEN,
                  F32_FLOP_S), None),
    }
    # the same kernels in the full backward's float32 modes, for comparison
    h32, c32, x32 = h.float(), c.float(), xb.float()
    ref = {"dwconv_gelu (float32 h, c)": lambda: fs.dwconv_gelu(h32, dw, dwb, HW, return_c=True),
           "layernorm_bwd (float32 x)": lambda: lv.layernorm_bwd(dy, x32, sc, up),
           "dwconv_gelu_bwd (float32 c, h)": lambda: lv.dwconv_gelu_bwd(da, c32, h32, dw, HW)}
    log("[s2] the float32 modes, for comparison: " + ", ".join(
        f"{name} {time_ms(fn):.4f} ms" for name, fn in ref.items()))
    del h32, c32, x32
    # a kernel mode's launches: its kernel's in the bf16res mode's run
    kernel = lambda name: name.split(" (")[0]  # noqa: E731
    rows += _line_rows(_check_rows("s2", kcases), TPU_S2, str,
                       lambda name: f"csrc/{kernel(name)}.cu",
                       lambda name: bf16res.get(kernel(name), 0))
    _bit_equal_twice("dwconv_gelu_bwd (bf16 c, h)", kcases["dwconv_gelu_bwd (bf16 c, h)"][0], "s2")
    _bit_equal_twice("dwconv_gelu (bf16 c)", kcases["dwconv_gelu (bf16 c)"][0], "s2")
    # the TMA body's instantiations, the bf16 c's among them
    _ptxas_report("s2", ("dwconv_gelu_kernel",))
    del h, c, da, dy, xb, up
    torch.cuda.empty_cache()
    return rows


def phase_s4():
    """S4 (scripts/microbench_layer.py) through its entry point at batch
    256: each forward variant (and the backward and the training forward's
    entry point) timed chained, its launches; each variant's output against
    its plain version (and its update, output - x, within LAYER_FWD_REL_L2);
    then the variant kernels alone at its shapes: head_group_attention
    (packed, paired, onehead; SDPA per head, or one 768-wide head with
    scale 1/8, as the library call), cross_attention with the heads summed,
    dwconv_gelu without the convolution and commuted (whose output must be
    base's, bit for bit); a group of one within 1e-5 of self_attention;
    every head_group_attention and dwconv_gelu mode bit-equal across two
    launches; ptxas's registers and spills of head_group_attention and of
    dwconv_gelu's pointwise pass (a spill fails)."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
    from transformer_latent_diffusion_tpu_torch.ops import layer_variants as lvar
    from transformer_latent_diffusion_tpu_torch.scripts import microbench_layer as s4
    from transformer_latent_diffusion_tpu_torch.scripts import probe_train_bwd_stage as s2

    F = torch.nn.functional
    _reset_counts()
    res = s4.main(["--batch", str(S4_B), "--device", DEVICE])
    log(f"[s4] launches of the probe's run: { {k: v for k, v in _counts().items() if v} }")
    x, cond, _, params = res["inputs"]
    xf = x.float()
    fwd_flops = s2.stage_flops(N, D, HIDDEN)["fwd"] * S4_B
    cases = {}
    for tag, am, dm in s4.VARIANTS:
        out = res["variants"][tag]["out"]
        want = lvar.fused_layer_fwd_variant_plain(am, dm, x, cond, params, HEADS, HW)
        r = rel_l2(out.float() - xf, want.float() - xf)
        log(f"[s4] {tag}: the layer's update, kernels vs plain: rel-L2 {r:.2e} "
            f"(bound {LAYER_FWD_REL_L2})")
        if not r < LAYER_FWD_REL_L2:
            raise AssertionError(f"s4 {tag}: the layer's update disagrees with the plain one")
        del want
        fn = (lambda am=am, dm=dm: lvar.fused_layer_fwd_variant(am, dm, x, cond, params,
                                                                HEADS, HW))
        plain = (lambda am=am, dm=dm: lvar.fused_layer_fwd_variant_plain(
            am, dm, x, cond, params, HEADS, HW))
        cases[tag] = (fn, plain, fn, plain,
                      bound(_nbytes(x, cond, params, out), fwd_flops, BF16_TENSOR_FLOP_S), None)
    launches = {tag: r["launches"] for tag, r in res["variants"].items()}
    rows = _line_rows(_check_rows("s4", cases), TPU_S4, "fused_layer_fwd_variant ({})".format,
                      lambda _: "ops/layer_variants.py",
                      lambda tag: sum(launches[tag].values()))
    base = res["variants"]["base"]["out"].float()
    for tag in s4.SAME_AS_BASE:
        log(f"[s4] {tag} max|diff| vs base: "
            f"{float((res['variants'][tag]['out'].float() - base).abs().max()):.3e}")
    log("[s4] summary (ms/call, chained): " + " ".join(
        f"{tag} {r['ms']:.3f}" for tag, r in res["variants"].items()))
    del res, base

    # the variant kernels alone, at the probe's shapes
    dev = torch.device(DEVICE)
    gen = torch.Generator(device="cpu").manual_seed(74)
    bf = torch.bfloat16
    m = S4_B * N

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * std).to(dev, dtype)

    qkv, res_x = randn(m, 3 * D, dtype=bf), randn(m, D)
    xr = res_x.clone()
    heads = qkv.reshape(S4_B, N, 3, HEADS, 64).permute(2, 0, 3, 1, 4).contiguous()
    wide = qkv.reshape(S4_B, N, 3, 1, D).permute(2, 0, 3, 1, 4).contiguous()
    attn_bound = bound(m * 3 * D * 2 + m * D * 8, 4 * S4_B * HEADS * N * N * 64,
                       BF16_TENSOR_FLOP_S)
    per_head = lambda: F.scaled_dot_product_attention(heads[0], heads[1], heads[2])  # noqa: E731
    one_head = lambda: F.scaled_dot_product_attention(  # noqa: E731
        wide[0], wide[1], wide[2], scale=1 / 8)
    kcases = {}
    # each kernel mode's launches: its kernel's in the variant that runs it
    runs = {"head_group_attention (packed)": "attn_packed",
            "head_group_attention (paired)": "attn_paired",
            "head_group_attention (onehead)": "attn_onehead",
            "cross_attention (summed heads)": "attn_onehead",
            "dwconv_gelu (none)": "nodw", "dwconv_gelu (commuted)": "dw_commuted"}
    for mode in ("packed", "paired", "onehead"):
        group, summed = lvar.attention_group(mode, HEADS)
        kcases[f"head_group_attention ({mode})"] = (
            lambda gr=group, su=summed: lvar.head_group_attention(
                qkv, res_x.clone(), HEADS, N, gr, su) - res_x,
            lambda gr=group, su=summed: lvar.head_group_attention_plain(
                qkv, res_x, HEADS, N, gr, su) - res_x,
            lambda gr=group, su=summed: lvar.head_group_attention(qkv, xr, HEADS, N, gr, su),
            lambda gr=group, su=summed: lvar.head_group_attention_plain(
                qkv, res_x, HEADS, N, gr, su),
            attn_bound, one_head if summed else per_head)
    qc, kv = randn(m, D, dtype=bf), randn(2 * S4_B, 2 * D, dtype=bf)
    ln = (1 + randn(D, std=0.1), randn(D, std=0.1))

    def updates(outs):
        return torch.cat([(outs[0] - res_x).flatten(), outs[1].float().flatten()])

    kcases["cross_attention (summed heads)"] = (
        lambda: updates(fs.cross_attention(qc, kv, res_x.clone(), ln, HEADS, N, True)),
        lambda: updates(fs.cross_attention_plain(qc, kv, res_x, ln, HEADS, N, True)),
        lambda: fs.cross_attention(qc, kv, xr, ln, HEADS, N, True),
        lambda: fs.cross_attention_plain(qc, kv, res_x, ln, HEADS, N, True),
        bound(m * D * 2 + 2 * S4_B * 2 * D * 2 + m * D * 8 + m * D * 2, 16 * m * D, F32_FLOP_S),
        None)
    h, dw, dwb = randn(m, HIDDEN), randn(9, HIDDEN, std=1 / 3, dtype=bf), randn(HIDDEN, std=0.1)
    dw_bytes = m * HIDDEN * 6 + 9 * HIDDEN * 2 + HIDDEN * 4
    for mode, ops in (("none", 8), ("commuted", 26)):
        kcases[f"dwconv_gelu ({mode})"] = (
            lambda mo=mode: fs.dwconv_gelu(h, dw, dwb, HW, dw_mode=mo),
            lambda mo=mode: fs.dwconv_gelu_plain(h, dw, dwb, HW, dw_mode=mo),
            lambda mo=mode: fs.dwconv_gelu(h, dw, dwb, HW, dw_mode=mo),
            lambda mo=mode: fs.dwconv_gelu_plain(h, dw, dwb, HW, dw_mode=mo),
            bound(dw_bytes, ops * m * HIDDEN, F32_FLOP_S), None)
    with torch.no_grad():
        same = torch.equal(fs.dwconv_gelu(h, dw, dwb, HW, dw_mode="commuted"),
                           fs.dwconv_gelu(h, dw, dwb, HW))
        one = rel_l2(lvar.head_group_attention(qkv, res_x.clone(), HEADS, N, 1, False) - res_x,
                     fs.self_attention(qkv, res_x.clone(), HEADS, N) - res_x)
    log(f"[s4] dwconv_gelu commuted equals base bit for bit: {same}")
    log(f"[s4] head_group_attention with groups of one against self_attention: rel-L2 "
        f"{one:.2e} (bound 1e-5)")
    if not same or not one < 1e-5:
        raise AssertionError("s4: commuted differs from base, or a group of one from "
                             "self_attention")
    log(f"[s4] the base modes, for comparison: self_attention "
        f"{time_ms(lambda: fs.self_attention(qkv, xr, HEADS, N)):.4f} ms, head_group_attention "
        f"with groups of one "
        f"{time_ms(lambda: lvar.head_group_attention(qkv, xr, HEADS, N, 1, False)):.4f} ms, "
        f"cross_attention {time_ms(lambda: fs.cross_attention(qc, kv, xr, ln, HEADS, N)):.4f} "
        f"ms, dwconv_gelu (base) {time_ms(lambda: fs.dwconv_gelu(h, dw, dwb, HW)):.4f} ms")
    kernel = lambda name: name.split(" (")[0]  # noqa: E731
    rows += _line_rows(_check_rows("s4", kcases), TPU_S4, str,
                       lambda name: f"csrc/{kernel(name)}.cu",
                       lambda name: launches[runs[name]].get(kernel(name), 0))
    # every head_group_attention and dwconv_gelu probe mode twice on the
    # same inputs (a fresh residual each time); the two kernels' registers
    for name in runs:
        if name.startswith(("head_group_attention", "dwconv_gelu")):
            _bit_equal_twice(name, kcases[name][0], "s4")
    _ptxas_report("s4", ("head_group_attention_kernel", "dwconv_gelu_pointwise_kernel"))
    del qkv, res_x, xr, heads, wide, qc, kv, h
    torch.cuda.empty_cache()
    return rows


# ------------------------------ float32: K1 and K7 in the JAX default ------------------------------

# each float32 body against its plain version on the card, TF32 off: both
# sum float32 products in float32, in different orders
F32_KERNEL_REL_L2 = 1e-5
# one float32 engine forward against the plain float32 forward (rel-L2)
F32_ENGINE_REL_L2 = 1e-4
# the float32 library run: 32 images x 50 DDIM steps, as the bf16 one
F32_IMGS, F32_ITER = 32, 50


def f32_bounds():
    """Least ms per decoder layer of each float32 body at the main path's
    shapes (each input read once, each output written once), against the
    card's float32 rate (no tensor cores: they take float32 as TF32)."""
    m = B * N
    gemms = [  # (rows, N, K, extra bytes: bias, residual)
        (m, 3 * D, D, 0), (m, D, D, 0), (2 * B, 2 * D, D, 0),
        (m, HIDDEN, D, HIDDEN * 4), (m, D, HIDDEN, m * D * 4 + D * 4)]
    gbytes = sum(4 * (r * k + n * k + r * n) + ex for r, n, k, ex in gemms)
    gflops = sum(2 * r * n * k for r, n, k, _ in gemms)
    return {
        "ln_gemm_f32": bound(gbytes, gflops, F32_FLOP_S),
        "self_attention_f32": bound(m * 3 * D * 4 + m * D * 8,
                                    4 * B * HEADS * N * N * 64, F32_FLOP_S),
        "cross_attention_f32": bound(m * D * 4 + 2 * B * 2 * D * 4 + m * D * 8 + m * D * 4,
                                     16 * m * D, F32_FLOP_S),
        "dwconv_gelu_f32": bound(m * HIDDEN * 8 + 9 * HIDDEN * 4 + HIDDEN * 4,
                                 26 * m * HIDDEN, F32_FLOP_S),
    }


def phase_float32_kernels():
    """[float32-kernels]: each float32 body (ops/fused_stack_f32.py) against
    its plain version at the main path's shapes (batch 64), TF32 off:
    rel-L2 within F32_KERNEL_REL_L2, two launches bit-equal, ms against
    the plain version, the bound and one PyTorch call, and ptxas's
    registers and spills. Returns (worst max-abs, timing, library,
    bounds), keyed by kernel."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

    F = torch.nn.functional
    dev = torch.device(DEVICE)
    g = torch.Generator(device="cpu").manual_seed(3)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    m = B * N
    x = randn(m, D)
    ln = (1.0 + randn(D, std=0.1), randn(D, std=0.1))
    wqkv, wq = randn(3 * D, D, std=D ** -0.5), randn(D, D, std=D ** -0.5)
    wkv = randn(2 * D, D, std=D ** -0.5)
    w1, b1 = randn(HIDDEN, D, std=D ** -0.5), randn(HIDDEN, std=0.1)
    w2, b2 = randn(D, HIDDEN, std=HIDDEN ** -0.5), randn(D, std=0.1)
    xn, act, cond = randn(m, D), randn(m, HIDDEN), randn(2 * B, D)
    qkv, qc, kv = randn(m, 3 * D), randn(m, D), randn(2 * B, 2 * D)
    hmat, dw, dwb = randn(m, HIDDEN), randn(9, HIDDEN, std=1 / 3), randn(HIDDEN, std=0.1)
    xr = x.clone()

    def updates(outs):
        return torch.cat([(outs[0] - x).flatten(), outs[1].flatten()])

    products = {
        "qkv": (lambda: fs.ln_gemm(x, wqkv, ln=ln), lambda: fs.ln_gemm_plain(x, wqkv, ln=ln)),
        "q": (lambda: fs.ln_gemm(x, wq, ln=ln), lambda: fs.ln_gemm_plain(x, wq, ln=ln)),
        "kv": (lambda: fs.ln_gemm(cond, wkv), lambda: fs.ln_gemm_plain(cond, wkv)),
        "kv_ragged": (lambda: fs.ln_gemm(cond[:4].contiguous(), wkv),
                      lambda: fs.ln_gemm_plain(cond[:4], wkv)),
        "expand": (lambda: fs.ln_gemm(xn, w1, bias=b1),
                   lambda: fs.ln_gemm_plain(xn, w1, bias=b1)),
        "contract": (lambda: fs.ln_gemm(act, w2, bias=b2, residual=x.clone()) - x,
                     lambda: fs.ln_gemm_plain(act, w2, bias=b2, residual=x) - x),
    }
    checks = [(f"ln_gemm_f32/{k}", "ln_gemm_f32", kern, plain)
              for k, (kern, plain) in products.items()] + [
        ("self_attention_f32", "self_attention_f32",
         lambda: fs.self_attention(qkv, x.clone(), HEADS, N) - x,
         lambda: fs.self_attention_plain(qkv, x, HEADS, N) - x),
        ("cross_attention_f32", "cross_attention_f32",
         lambda: updates(fs.cross_attention(qc, kv, x.clone(), ln, HEADS, N)),
         lambda: updates(fs.cross_attention_plain(qc, kv, x, ln, HEADS, N))),
        ("cross_attention_f32 (ln=None, K7)", "cross_attention_f32",
         lambda: fs.cross_attention(qc, kv, x.clone(), None, HEADS, N)[0] - x,
         lambda: fs.cross_attention_plain(qc, kv, x, None, HEADS, N)[0] - x),
        ("dwconv_gelu_f32", "dwconv_gelu_f32", lambda: fs.dwconv_gelu(hmat, dw, dwb, HW),
         lambda: fs.dwconv_gelu_plain(hmat, dw, dwb, HW)),
    ]
    worst = {}
    for label, name, kern, plain in checks:
        r, a, rel_a = _errors(kern(), plain())
        log(f"[float32-kernels] {label}: rel-L2 {r:.3e} max-abs {a:.3e} ({rel_a:.2e} of "
            f"max |ref|; bound rel-L2 {F32_KERNEL_REL_L2})")
        if not r <= F32_KERNEL_REL_L2:
            raise AssertionError(f"{label} disagrees with its plain version")
        worst[name] = max(worst.get(name, 0.0), a)
    # one writer per element and one fixed summation order: two launches bit-equal
    _bit_equal_twice("ln_gemm_f32 (the five products)", lambda: (
        fs.ln_gemm(x, wqkv, ln=ln), fs.ln_gemm(x, wq, ln=ln), fs.ln_gemm(cond, wkv),
        fs.ln_gemm(xn, w1, bias=b1), fs.ln_gemm(act, w2, bias=b2, residual=x.clone())),
        "float32-kernels")
    _bit_equal_twice("self_attention_f32",
                     lambda: fs.self_attention(qkv, x.clone(), HEADS, N), "float32-kernels")
    _bit_equal_twice("cross_attention_f32",
                     lambda: fs.cross_attention(qc, kv, x.clone(), ln, HEADS, N),
                     "float32-kernels")
    _bit_equal_twice("dwconv_gelu_f32", lambda: fs.dwconv_gelu(hmat, dw, dwb, HW),
                     "float32-kernels")
    _ptxas_report("float32-kernels", ("ln_gemm_f32_kernel", "self_attention_f32_kernel",
                                      "cross_attention_kernel", "dwconv_gelu_kernel"))

    results = {
        "ln_gemm_f32": (
            lambda: (fs.ln_gemm(x, wqkv, ln=ln), fs.ln_gemm(x, wq, ln=ln),
                     fs.ln_gemm(cond, wkv), fs.ln_gemm(xn, w1, bias=b1),
                     fs.ln_gemm(act, w2, bias=b2, residual=xr)),
            lambda: (fs.ln_gemm_plain(x, wqkv, ln=ln), fs.ln_gemm_plain(x, wq, ln=ln),
                     fs.ln_gemm_plain(cond, wkv), fs.ln_gemm_plain(xn, w1, bias=b1),
                     fs.ln_gemm_plain(act, w2, bias=b2, residual=x))),
        "self_attention_f32": (lambda: fs.self_attention(qkv, xr, HEADS, N),
                               lambda: fs.self_attention_plain(qkv, x, HEADS, N)),
        "cross_attention_f32": (lambda: fs.cross_attention(qc, kv, xr, ln, HEADS, N),
                                lambda: fs.cross_attention_plain(qc, kv, x, ln, HEADS, N)),
        "dwconv_gelu_f32": (lambda: fs.dwconv_gelu(hmat, dw, dwb, HW),
                            lambda: fs.dwconv_gelu_plain(hmat, dw, dwb, HW)),
    }
    timing = time_against_plain(results, "float32-kernels")
    heads = qkv.reshape(B, N, 3, HEADS, 64).permute(2, 0, 3, 1, 4).contiguous()
    qh = qc.reshape(B, N, HEADS, 64).transpose(1, 2).contiguous()
    kvh = kv.reshape(B, 2, 2, HEADS, 64).permute(2, 0, 3, 1, 4).contiguous()
    library = {
        # F.linear x5 in float32, TF32 off (phase_env)
        "ln_gemm_f32": time_ms(lambda: (F.linear(x, wqkv), F.linear(x, wq), F.linear(cond, wkv),
                                        F.linear(xn, w1, b1), F.linear(act, w2, b2))),
        "self_attention_f32": time_ms(
            lambda: F.scaled_dot_product_attention(heads[0], heads[1], heads[2])),
        "cross_attention_f32": time_ms(
            lambda: F.scaled_dot_product_attention(qh, kvh[0], kvh[1])),
        "dwconv_gelu_f32": None,  # no one call: a depthwise conv, then a GELU
    }
    library["dwconv_gelu_f32 (equal work)"] = time_ms(
        dw_equal_work(hmat, dw, dwb, HW, out_dtype=torch.float32))
    bounds = f32_bounds()
    for name in results:
        ms, plain_ms = timing[name]
        lib = library[name]
        log(f"[float32-kernels] {name}: {ms:.4f} ms per layer, plain {plain_ms:.4f} ms, bound "
            f"{bounds[name][0]:.4f} ms ({bounds[name][1]}; {bounds[name][0] / ms:.1%} of it), "
            f"library call {'none' if lib is None else f'{lib:.4f} ms'}")
    log(f"[float32-kernels] dwconv_gelu_f32: equal-work yardstick (F.conv2d groups=C with "
        f"bias + F.gelu, float32, cudnn TF32 off) "
        f"{library['dwconv_gelu_f32 (equal work)']:.4f} ms")
    return worst, timing, library, bounds


def f32_config(cfg):
    """The flagship with the JAX package's default compute dtype, float32."""
    from transformer_latent_diffusion_tpu_torch.configs import DenoiserLoad

    return dataclasses.replace(cfg, denoiser_load=DenoiserLoad(dtype="float32"))


def phase_float32_engine(cfg32):
    """[float32-engine]: one float32 fused-engine forward at batch B against
    the plain float32 Denoiser forward on the card (TF32 off), with its
    launches (the float32 bodies only) and times; then the W8A8 engine with
    a float32 compute dtype against its plain stack."""
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import make_fused_apply
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack_f32 as f32
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack_int8 as q8
    from transformer_latent_diffusion_tpu_torch.utils.common import init_random_weights_

    dev = torch.device(DEVICE)
    den = cfg32.denoiser_cfg
    model = Denoiser.from_config(den, dtype=torch.float32)
    init_random_weights_(model, 0)
    model.to(dev).eval()
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(B, 4, den.image_size, den.image_size, generator=g).to(dev)
    noise = torch.full((B, 1), 0.5, device=dev)
    label = torch.randn(B, den.text_emb_size, generator=g).to(dev)
    sd = model.state_dict()
    for quantize in (None, "int8"):
        tag = "float32 engine" if quantize is None else "float32 W8A8 engine"
        engine = make_fused_apply(den, compute_dtype=torch.float32, quantize=quantize)
        with torch.no_grad():
            prepared = engine.prepare(sd)
            _reset_counts()
            out = engine.apply_prepared(prepared, x, noise, label)
            launches = _counts()
            if quantize is None:
                ref = model(x, noise, label)
                bound_r = F32_ENGINE_REL_L2
            else:
                tokens, cond, h, w = engine._prologue(sd, x, noise, label)
                for layer in prepared["layers"]:
                    tokens = q8.fused_layer_stack_int8_plain(tokens, cond, layer, h,
                                                             engine.n_heads)
                ref = engine._epilogue(sd, tokens, h, w)
                bound_r = INT8_ENGINE_REL_L2
        torch.cuda.synchronize()
        expect = _expect({k: v * den.n_layers
                          for k, v in f32.launches_per_layer(torch.float32, quantize).items()})
        r = rel_l2(out, ref)
        log(f"[float32-engine] {tag} vs the plain float32 "
            f"{'forward' if quantize is None else 'int8 stack'}, batch {B}: rel-L2 {r:.3e} "
            f"(bound {bound_r}); launches { {k: v for k, v in launches.items() if v} }")
        if not (torch.isfinite(out).all() and r <= bound_r):
            raise AssertionError(f"the {tag} disagrees with its plain version")
        _require_launches(launches, expect, f"[float32-engine] {tag}")
        with torch.no_grad():
            fwd = lambda: engine.apply_prepared(prepared, x, noise, label)  # noqa: E731
            plain = lambda: model(x, noise, label)  # noqa: E731
            t_plain = [time_ms(plain, 3, 1)]
            t_eng = [time_ms(fwd, 3, 1), time_ms(fwd, 3, 1)]
            t_plain.append(time_ms(plain, 3, 1))
        log(f"[float32-engine] {tag}, one forward at batch {B}: {np.mean(t_eng):.3f} ms, "
            f"the plain float32 Denoiser {np.mean(t_plain):.3f} ms (runs {t_eng}, {t_plain})")
        del prepared
    del model


def phase_float32_serving(smi):
    """[float32-serving]: the service with no config, `LTDConfig()` as the
    JAX service builds it (a float32 denoiser of 3 layers, d = 128, 8 x 8
    tokens): three default requests over HTTP, each with its float32
    launches (15 DPM++ steps, one image: 15 forwards x 3 layers), the
    loop's key captured at the second and replayed at the third."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack_f32 as f32
    from transformer_latent_diffusion_tpu_torch.serve.app import GenerationService

    svc = GenerationService(device=DEVICE)
    tr = svc.transformer
    if tr.cfg.denoiser_load.dtype != "float32" or tr.diffuser.fast_apply.dtype != torch.float32:
        raise AssertionError("the service's default is not the float32 LTDConfig()")
    _reset_counts()
    phase_serving(svc, "float32-serving")
    launches = {k: v for k, v in _counts().items() if v}
    expect = {k: v * tr.cfg.denoiser_cfg.n_layers * 15 * 3
              for k, v in f32.LAUNCHES_PER_LAYER.items()}
    graphs = tr.diffuser.graphs
    log(f"[float32-serving] LTDConfig() (float32, {tr.cfg.denoiser_cfg.n_layers} layers, "
        f"d = {tr.cfg.denoiser_cfg.embed_dim}): launches of the 3 requests {launches} "
        f"(expected {expect}); graph captures {graphs.captures}, replays {graphs.replays}; "
        f"{smi}")
    _require_launches(launches, expect, "[float32-serving]")
    if (graphs.captures, graphs.replays) != (1, 2):
        raise AssertionError("the default request's loop was not captured and replayed")
    del svc, tr


MB_REQS = 8  # concurrent one-image requests: one loop at CFG batch 16


def phase_microbatch(tr, smi):
    """[microbatch]: the service with the micro-batcher on the float32
    flagship: MB_REQS concurrent one-image HTTP requests coalesce into one
    sampler call of MB_REQS images (CFG batch 2 x MB_REQS) with one loop's
    launches; MB_REQS concurrent batcher calls each within one uint8 step
    of its solo run; a burst past max_queue_imgs answered 503 with
    Retry-After."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack_f32 as f32
    from transformer_latent_diffusion_tpu_torch.serve.app import GenerationService

    svc = GenerationService(transformer=tr, microbatch=MB_REQS, max_wait_ms=2000.0,
                            max_queue_imgs=MB_REQS)
    calls = []
    orig = tr.diffuser.generate
    gate = threading.Event()
    gate.set()

    def spy(*a, **kw):
        calls.append(kw["num_imgs"])
        gate.wait(300)
        return orig(*a, **kw)

    tr.diffuser.generate = spy
    n_layers = tr.cfg.denoiser_cfg.n_layers
    loop = {k: v * n_layers * 15 for k, v in f32.LAUNCHES_PER_LAYER.items()}

    def concurrently(fns):
        out = [None] * len(fns)
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, fns[i]()))
                   for i in range(len(fns))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    try:
        with _wsgi_server(svc) as request:
            walls = []
            for round_ in range(3):  # the bucket's loop: eager, captured, replayed
                calls.clear()
                _reset_counts()
                t0 = time.perf_counter()
                replies = concurrently([
                    lambda i=i: request("/generate-image/", {"prompt": f"a cute cat {i}",
                                                             "seed": i})
                    for i in range(MB_REQS)])
                wall = time.perf_counter() - t0
                walls.append(wall)
                launches = {k: v for k, v in _counts().items() if v}
                log(f"[microbatch] round {round_}: {MB_REQS} concurrent one-image requests "
                    f"in {wall:.3f} s: statuses {[s for s, _ in replies]}, sampler calls "
                    f"{calls} (CFG batch {2 * sum(calls)}), launches {launches} (one loop: "
                    f"{loop})")
                if any(s != 200 or not b.startswith(b"\xff\xd8\xff") for s, b in replies):
                    raise AssertionError("[microbatch] a request failed")
                if calls != [MB_REQS]:
                    raise AssertionError(f"[microbatch] requests did not coalesce: {calls}")
                _require_launches(launches, loop, "[microbatch] one batched loop")
            # a burst past the queue's bound: the sampler held until it is in
            gate.clear()
            held = threading.Thread(target=lambda: concurrently([
                lambda i=i: request("/generate-image/", {"prompt": f"burst {i}", "seed": i})
                for i in range(MB_REQS)]))
            held.start()
            for _ in range(3000):
                if svc.batcher.queue_depth() == MB_REQS:
                    break
                time.sleep(0.01)
            status, body = request("/generate-image/", {"prompt": "one too many"})
            retry = request.headers.get("Retry-After")
            health = json.loads(request("/healthz")[1])
            gate.set()
            held.join()
            log(f"[microbatch] burst of {MB_REQS + 1} against max_queue_imgs {MB_REQS}: the "
                f"last -> {status} {body[:80]!r}, Retry-After {retry} s; /healthz queue "
                f"{health['queue_imgs']}/{health['queue_limit']}")
            if status != 503 or retry is None or health["queue_imgs"] != MB_REQS:
                raise AssertionError("[microbatch] the full queue was not answered 503 with "
                                     "Retry-After")
        # the same 8 requests one after another, without the batcher (each
        # a replay of the one-image loop after its first two calls)
        solo_svc = GenerationService(transformer=tr)
        with _wsgi_server(solo_svc) as request:
            for i in range(2):
                request("/generate-image/", {"prompt": "warm-up", "seed": i})
            t0 = time.perf_counter()
            for i in range(MB_REQS):
                request("/generate-image/", {"prompt": f"a cute cat {i}", "seed": i})
            serial = time.perf_counter() - t0
        log(f"[microbatch] {MB_REQS} requests: {walls[-1]:.3f} s coalesced (the replay "
            f"round), {serial:.3f} s one after another without the batcher; {smi}")

        # pixels: each batched image against its solo run (no JPEG between)
        tr.diffuser.generate = orig
        reqs = [dict(prompt=f"a photo of thing {i}", seed=100 + i,
                     class_guidance=2.0 + i) for i in range(MB_REQS)]
        calls.clear()
        tr.diffuser.generate = spy
        batched = concurrently([lambda r=r: svc.batcher.generate(**r, n_iter=15, timeout=600)
                                for r in reqs])
        tr.diffuser.generate = orig
        worst = 0
        for r, img in zip(reqs, batched):  # PIL grids of one image, as the solo call's
            solo = tr.generate_image_from_text(r["prompt"], seed=r["seed"], num_imgs=1,
                                               n_iter=15, class_guidance=r["class_guidance"])
            worst = max(worst, int(np.abs(np.asarray(img).astype(np.int32)
                                          - np.asarray(solo).astype(np.int32)).max()))
        log(f"[microbatch] {MB_REQS} concurrent batcher calls (sampler calls {calls}): each "
            f"image against its solo run, max |uint8 diff| {worst} (bound 1); {smi}")
        if calls != [MB_REQS] or worst > 1:
            raise AssertionError("[microbatch] batched images differ from their solo runs")
    finally:
        gate.set()
        tr.diffuser.generate = orig
        svc.batcher.close()


def main():
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

    t_start = time.perf_counter()
    smi = phase_env()
    phase_build()
    worst, timing, library = phase_kernels()
    cfg = flagship_configs()
    phase_engine(cfg)
    torch.cuda.empty_cache()
    tr, launches, ips = phase_library(cfg)
    from transformer_latent_diffusion_tpu_torch.serve.app import GenerationService

    phase_sampler_graph(tr, fs.LAUNCHES_PER_LAYER, "sampler-graph", N_IMGS, N_ITER)
    phase_graph_keys(tr)
    phase_sampler_extras(tr)
    phase_serving(GenerationService(transformer=tr))
    phase_resized_grid(tr)
    phase_editing(tr, smi)
    del tr
    torch.cuda.empty_cache()

    from transformer_latent_diffusion_tpu_torch.ops import fused_stack_f32 as f32

    f_worst, f_timing, f_library, f_bounds = phase_float32_kernels()
    cfg32 = f32_config(cfg)
    phase_float32_engine(cfg32)
    torch.cuda.empty_cache()
    tr, f_launches, ips32 = phase_library(cfg32, f32.LAUNCHES_PER_LAYER, "float32-library")
    log(f"[float32-library] {ips32:.3f} images/s (float32, the JAX default) against "
        f"{ips:.3f} (bf16 engine, the library phase above)")
    phase_sampler_graph(tr, f32.LAUNCHES_PER_LAYER, "float32-sampler-graph",
                        GRAPH_BRIEF_IMGS, GRAPH_BRIEF_ITER)
    phase_microbatch(tr, smi)
    del tr
    torch.cuda.empty_cache()
    phase_float32_serving(smi)
    torch.cuda.empty_cache()

    from transformer_latent_diffusion_tpu_torch.ops import fused_stack_int8 as q8

    i_worst, i_timing, i_library, i_bounds = phase_int8_kernels()
    cfg8 = dataclasses.replace(cfg, quantize="int8")
    phase_int8_engine(cfg8)
    torch.cuda.empty_cache()
    tr, i_launches, ips8 = phase_library(cfg8, q8.LAUNCHES_PER_LAYER, "int8-library")
    log(f"[int8-library] {ips8:.3f} images/s (W8A8) against {ips:.3f} (bf16 engine, the "
        f"library phase above)")
    phase_sampler_graph(tr, q8.LAUNCHES_PER_LAYER, "int8-sampler-graph", GRAPH_BRIEF_IMGS,
                        GRAPH_BRIEF_ITER)
    del tr
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:  # as `serve --config ltd.json` loads it
        from transformer_latent_diffusion_tpu_torch.configs import (
            config_to_json,
            ltd_config_from_json,
        )

        path = os.path.join(tmp, "ltd.json")
        with open(path, "w") as f:
            f.write(config_to_json(cfg8))
        phase_serving(GenerationService(cfg=ltd_config_from_json(path), device=DEVICE),
                      "int8-serving")
    torch.cuda.empty_cache()
    s1 = phase_s1()
    phase_widths()

    h_worst, h_timing, h_library, h_bounds = phase_hires_kernels()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cfg512 = hires_config(tmp, 64)
        phase_hires_model(cfg512)
        torch.cuda.empty_cache()
        tr, h_launches = phase_hires_library(cfg512, HR_IMGS, HR_ITER, smi)
        phase_sampler_graph(tr, _hires_per_layer(cfg512.denoiser_cfg), "hires-sampler-graph",
                            GRAPH_BRIEF_IMGS, GRAPH_BRIEF_ITER)
        del tr
        torch.cuda.empty_cache()
        phase_serving(GenerationService(cfg=cfg512, device=DEVICE), "hires-serving")
        torch.cuda.empty_cache()
        tr, _ = phase_hires_library(hires_config(tmp, 128), XR_IMGS, XR_ITER, smi)
        del tr
        torch.cuda.empty_cache()

    t_worst, t_timing, t_library, t_bounds = phase_train_kernels()
    torch.cuda.empty_cache()
    per_layer, _, _ = phase_train_layer()
    torch.cuda.empty_cache()
    phase_train_step(smi)
    t_launches, _ = phase_train_main(per_layer, smi)
    torch.cuda.empty_cache()
    phase_outpaint_train(per_layer, smi)

    ht_worst, ht_timing, ht_library, ht_bounds = phase_hires_train_kernels()
    hr_layer, xr_launches = phase_hires_train_step(smi)
    ft_launches = phase_hires_finetune(hr_layer, smi)
    phase_multires(hr_layer, smi)
    torch.cuda.empty_cache()

    p_worst, p_timing, p_library, p_bounds, p_launches = phase_attn_pair_kernels()
    torch.cuda.empty_cache()
    ffn_launches = {}
    for mlp_class in ("moe", "mlp"):
        phase_ffn_serving(mlp_class, smi)
        ffn_launches[mlp_class], _, _ = phase_ffn_train(mlp_class, smi)
    torch.cuda.empty_cache()

    probe_rows = phase_s3() + phase_s2() + phase_s4()
    unlaunched = [r["name"] for r in probe_rows if not r["launches"]]
    if unlaunched:
        raise AssertionError(f"the probes' runs launched no kernel for {unlaunched}")

    from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

    bounds = k1_bounds()
    port = "transformer_latent_diffusion_tpu_torch"
    sources = {**{k: f"csrc/{k}.cu" for k in fs.KERNELS},
               "weight_grad": "csrc/gemm_bwd.cu", "colsum": "csrc/gemm_bwd.cu",
               "layernorm_bwd": "csrc/layernorm_bwd.cu",
               "dwconv_gelu_bwd": "csrc/dwconv_gelu_bwd.cu",
               "self_attention_bwd": "csrc/attention_bwd.cu",
               "cross_attention_bwd": "csrc/attention_bwd.cu",
               "flash_attention": "csrc/flash_attention.cu",
               # composes ln_gemm.cu and dwconv_gelu.cu's row-band body
               "fused_mlp_sepconv": "ops/fused_mlp_vjp.py",
               "flash_attention_bwd": "csrc/flash_attention_bwd.cu",
               # composes the K1/K2 kernels and dwconv_gelu_bwd.cu's row-band body
               "fused_mlp_sepconv_bwd": "ops/fused_mlp_vjp.py",
               "rowquant": "csrc/rowquant.cu", "gemm_i8": "csrc/gemm_i8.cu",
               # the float32 bodies (ops/fused_stack_f32.py)
               "ln_gemm_f32": "csrc/ln_gemm_f32.cu",
               "self_attention_f32": "csrc/self_attention_f32.cu",
               "cross_attention_f32": "csrc/cross_attention.cu",
               "dwconv_gelu_f32": "csrc/dwconv_gelu.cu"}
    kernels = []
    for names, tpu, counts, err, tim, lib, bnd in (
            (fs.KERNELS, TPU_KERNEL, launches, worst, timing, library, bounds),
            (f32.KERNELS, TPU_KERNEL, f_launches, f_worst, f_timing, f_library, f_bounds),
            (lv.KERNELS, TPU_K2_BWD, t_launches, t_worst, t_timing, t_library, t_bounds),
            (("flash_attention",), TPU_K3, h_launches, h_worst, h_timing, h_library,
             h_bounds),
            (("fused_mlp_sepconv",), TPU_K5, h_launches, h_worst, h_timing, h_library,
             h_bounds),
            (q8.KERNELS, TPU_K7, i_launches, i_worst, i_timing, i_library, i_bounds)):
        for name in names:
            kernels.append({
                "name": name, "route": "cuda", "source": f"{port}/{sources[name]}",
                "replaces": tpu, "launches": counts[name], "max_abs_err": err[name],
                "ms": tim[name][0], "plain_ms": tim[name][1], "bound_ms": bnd[name][0],
                "bound_by": bnd[name][1], "library_ms": lib[name],
            })
            if f"{name} (equal work)" in lib:
                kernels[-1]["equal_work_ms"] = lib[f"{name} (equal work)"]
    # K4a and K4b are one Hopper kernel: a row at 512 px (B = 64, N = 1024;
    # launches of the fine-tune) and one at 4096 tokens (B = 2; launches of
    # the 1024 px step); K5's backward and its row-band dwconv_gelu_bwd at
    # 512 px (launches of the fine-tune)
    for row, name, key, tpu, counts, err in (
            ("flash_attention_bwd", "flash_attention_bwd", "flash_attention_bwd", TPU_K4A,
             ft_launches, "flash_attention_bwd"),
            ("flash_attention_bwd (N = 4096)", "flash_attention_bwd", "k4b", TPU_K4B,
             xr_launches, "flash_attention_bwd"),
            ("fused_mlp_sepconv_bwd", "fused_mlp_sepconv_bwd", "fused_mlp_sepconv_bwd",
             TPU_K5_BWD, ft_launches, "fused_mlp_sepconv_bwd"),
            ("dwconv_gelu_bwd (row band, hw = 32)", "dwconv_gelu_bwd",
             "dwconv_gelu_bwd (row band)", TPU_K5_BWD, ft_launches,
             "dwconv_gelu_bwd (row band)")):
        kernels.append({
            "name": row, "route": "cuda", "source": f"{port}/{sources[name]}",
            "replaces": tpu, "launches": counts[name], "max_abs_err": ht_worst[err],
            "ms": ht_timing[key][0], "plain_ms": ht_timing[key][1],
            "bound_ms": ht_bounds[key][0], "bound_by": ht_bounds[key][1],
            "library_ms": ht_library[key],
        })
        if f"{key} (equal work)" in ht_library:
            kernels[-1]["equal_work_ms"] = ht_library[f"{key} (equal work)"]
    # K6's launches: the MoE model's train.main; K8's and K9's: their entry
    # points (no path of the system calls them, as in the JAX package)
    for name, tpu, src, counts in (
            ("fused_attention_pair_vjp", TPU_K6_FWD, "ops/fused_attn_vjp.py",
             ffn_launches["moe"]),
            ("fused_attention_pair_vjp_bwd", TPU_K6_BWD, "ops/fused_attn_vjp.py",
             ffn_launches["moe"]),
            ("fused_block.fused_attention_pair", TPU_K8, "ops/fused_block.py", p_launches),
            ("fused_block.fused_mlp_sepconv", TPU_K9, "ops/fused_block.py", p_launches)):
        kernels.append({
            "name": name, "route": "cuda", "source": f"{port}/{src}", "replaces": tpu,
            "launches": counts[name], "max_abs_err": p_worst[name], "ms": p_timing[name][0],
            "plain_ms": p_timing[name][1], "bound_ms": p_bounds[name][0],
            "bound_by": p_bounds[name][1], "library_ms": p_library[name],
        })
        if f"{name} (equal work)" in p_library:
            kernels[-1]["equal_work_ms"] = p_library[f"{name} (equal work)"]
    # the probes (no serving or training path runs them): S1's pair, and a
    # row per variant or mode of S3, S2 and S4 and per kernel mode they add;
    # launches are those of the probe's own run (a kernel mode's: its
    # kernel's launches in the variant that runs it)
    kernels.append({
        "name": "s1 W8A8 MLP pair (rowquant + gemm_i8)", "route": "cuda",
        "source": f"{port}/scripts/microbench_int8.py", "replaces": TPU_S1,
        "launches": sum(s1["launches"].values()), "max_abs_err": s1["max_abs"], "ms": s1["ms"],
        "plain_ms": s1["plain_ms"], "bound_ms": s1["bound"][0], "bound_by": s1["bound"][1],
        "library_ms": None, "equal_work_ms": s1["equal_work_ms"]})
    kernels += probe_rows
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
