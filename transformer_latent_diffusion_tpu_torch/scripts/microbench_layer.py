"""Microbenchmark of decoder-layer forward variants on the card: the port of
scripts/microbench_layer.py (S4).

Times the training layer's forward (TPU kernel K2's, through K1's kernels)
with one stage swapped for a variant (`fused_layer_fwd_variant` in
ops/layer_variants.py), chaining each variant `--iters` times (the output
feeds the next call's input) at the training shapes (N = 256 tokens,
D = 768, hidden 3072, hw = 16, 12 heads):

  base          the training forward
  bwd_base      the training backward (chained on dx)
  nodw          the forward without the 3x3 depthwise convolution (GELU kept)
  dw_commuted   the depthwise convolution with its shifts commuted: a
                thread slides along a row, taking each column's three row
                taps once
  attn_onehead  one 768-wide head instead of 12 (wrong math on purpose:
                the same products, one softmax; isolates the head loop)
  attn_packed   per-head products, one row max shared by all 12 heads
  attn_paired   the same with the max shared by each pair of heads
  best_combo    attn_packed with dw_commuted

Usage: python -m transformer_latent_diffusion_tpu_torch.scripts.microbench_layer
           [--batch 256] [--iters 20] [--device cuda]
           [--hw 16] [--dim 768] [--hidden 3072] [--heads 12]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
from transformer_latent_diffusion_tpu_torch.ops import layer_variants as lvar
from transformer_latent_diffusion_tpu_torch.scripts import _probe

# (tag, attn_mode, dw_mode), in the JAX probe's order
VARIANTS = (("base", "base", "base"),
            ("nodw", "base", "none"),
            ("dw_commuted", "base", "commuted"),
            ("attn_onehead", "onehead", "base"),
            ("attn_packed", "packed", "base"),
            ("attn_paired", "paired", "base"),
            ("best_combo", "packed", "commuted"))
# the variants that compute base's function
SAME_AS_BASE = ("dw_commuted", "attn_packed", "attn_paired", "best_combo")


def make_inputs(batch, hw, d, hidden, dev, seed=0):
    """The JAX probe's inputs (its numpy draws, in its order): every
    parameter 0.02 standard normal (LayerNorms and biases float32, the
    rest bf16), then x, cond and the upstream gradient g standard normal
    in bf16; in the port's layouts ((out, in) products, (9, hidden) taps)
    on `dev`."""
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16

    def mk(shape, f32=False):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.02)
        return a if f32 else a.to(bf)

    params = [mk((d,), True), mk((d,), True), mk((d, 3 * d)).T,
              mk((d,), True), mk((d,), True), mk((d, d)).T, mk((d, 2 * d)).T,
              mk((d,), True), mk((d,), True), mk((d, hidden)).T, mk((hidden,), True),
              mk((3, 3, hidden)).reshape(9, hidden), mk((hidden,), True),
              mk((hidden, d)).T, mk((d,), True)]
    n = hw * hw
    x, cond, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, bf)
                  for s in ((batch, n, d), (batch, 2, d), (batch, n, d)))
    return x, cond, g, [p.contiguous().to(dev) for p in params]


def time_chained(fn, x, cond, iters, tag, dev):
    """ms per call of `fn` chained `iters` times, three times over, after
    one chained run (the JAX probe's warm-up and compile)."""
    def chained(out):
        for _ in range(iters):
            out = fn(out, cond)
        return out

    t0 = time.perf_counter()
    out = chained(x)
    _probe.sync(dev)
    first = time.perf_counter() - t0
    reps = 3
    ms = _probe.time_ms(lambda: chained(out), dev, reps, warmup=0) / iters
    print(f"{tag:16s} {ms:8.3f} ms/call   (first {first:.1f}s)", flush=True)
    return ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hw", type=int, default=16)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--hidden", type=int, default=3072)
    ap.add_argument("--heads", type=int, default=12)
    args = ap.parse_args(argv)
    dev = _probe.get_device(args.device)
    hw, heads = args.hw, args.heads
    print(f"device={_probe.describe(dev)} batch={args.batch}", flush=True)
    x, cond, g, params = make_inputs(args.batch, hw, args.dim, args.hidden, dev)

    def variant(attn_mode, dw_mode):
        return lambda xx, cc: lvar.fused_layer_fwd_variant(attn_mode, dw_mode, xx, cc,
                                                           params, heads, hw)

    results = {}
    with torch.no_grad():
        outs = {tag: variant(am, dm)(x, cond) for tag, am, dm in VARIANTS}
        # correctness cross-check (the variants that keep base's function)
        ya = outs["base"].float()
        for tag in SAME_AS_BASE:
            err = float((outs[tag].float() - ya).abs().max())
            print(f"{tag} max|diff| vs base: {err:.3e}", flush=True)
        for tag, am, dm in VARIANTS:
            before = _probe.launch_counts()
            ms = time_chained(variant(am, dm), x, cond, args.iters, tag, dev)
            results[tag] = dict(attn_mode=am, dw_mode=dm, ms=ms, out=outs[tag],
                                launches=_probe.launches_since(before))

        def bwd_fn(xx, cc):  # chained on dx, which has x's shape
            return lv.fused_layer_bwd(xx, cc, g, params, heads, hw)[0]

        def fwd_lib(xx, cc):  # the training forward's entry point
            return lv.fused_layer_fwd(xx, cc, params, heads, hw)

        for tag, fn in (("bwd_base", bwd_fn), ("fwd_lib", fwd_lib)):
            before = _probe.launch_counts()
            ms = time_chained(fn, x, cond, args.iters, tag, dev)
            results[tag] = dict(ms=ms, launches=_probe.launches_since(before))

    unit = "ms/call" if dev.type == "cuda" else "ms/call, host clock"
    print(f"\nsummary ({unit}):", flush=True)
    for tag, r in results.items():
        print(f"  {tag:16s} {r['ms']:8.3f}", flush=True)
    return dict(inputs=(x, cond, g, params), variants=results)


if __name__ == "__main__":
    main()
