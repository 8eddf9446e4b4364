"""Per-stage split of the training layer's backward (TPU kernel K2's) on the
card: the port of scripts/probe_train_bwd_stage.py (S2).

Times the layer's backward (`fused_layer_bwd_variant` in
ops/fused_layer_vjp.py, the kernels of csrc/) in the JAX probe's modes,
same process, at the flagship layer's shapes:

  fwd        the training forward (baseline sanity)
  full       the whole backward, recomputing the forward
  bf16res    the same with the recompute's residuals kept in bf16
  recompute  the recompute alone
  no_mlp     full without the MLP section
  no_cross   full without the cross-attention section
  no_self    full without the self-attention section

Every mode runs the whole recompute. The port has no dead-code
elimination to defeat, so a skipped section is simply not run. The shares
(full - ablated) say where the backward's time goes; the operation counts
per stage are computed from the shapes (`stage_flops`).

Usage: python -m transformer_latent_diffusion_tpu_torch.scripts.probe_train_bwd_stage
           [--batch 256] [--reps 20] [--device cuda]
           [--hw 16] [--dim 768] [--hidden 3072] [--heads 12]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
from transformer_latent_diffusion_tpu_torch.scripts import _probe

MODES = lv.BWD_MODES


def param_shapes(d, hidden):
    """The JAX package's parameter shapes (`_param_shapes`: (in, out)
    products, (1, C) rows, (9, hidden) taps)."""
    return [(1, d), (1, d), (d, 3 * d), (1, d), (1, d), (d, d), (d, 2 * d),
            (1, d), (1, d), (d, hidden), (1, hidden), (9, hidden),
            (1, hidden), (hidden, d), (1, d)]


def to_port(arrays, hidden, dtype=torch.bfloat16):
    """JAX-layout parameter arrays -> the port's: (out, in) products and
    (9, hidden) taps in `dtype`, vectors rounded to `dtype` and held as
    float32 (the kernels take the LayerNorms and biases in float32)."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.asarray(a, np.float32))
        if t.ndim == 1:
            out.append(t.to(dtype).float())
        elif t.ndim == 3:
            out.append(t.reshape(9, hidden).to(dtype))
        else:
            out.append(t.T.contiguous().to(dtype))
    return out


def make_inputs(batch, hw, d, hidden, dev, seed=0):
    """The JAX probe's inputs (its numpy draws, in its order): x, cond and
    the upstream gradient g standard normal in bf16, every parameter 0.02
    standard normal rounded to bf16; in the port's layouts on `dev`."""
    rng = np.random.default_rng(seed)
    n = hw * hw
    x, cond, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  .to(dev, torch.bfloat16) for s in ((batch, n, d), (batch, 2, d),
                                                     (batch, n, d)))
    arrays = []
    for s in param_shapes(d, hidden):
        if s[0] == 1:
            arr = rng.standard_normal(s[1])
        elif s == (9, hidden):
            arr = rng.standard_normal((3, 3, hidden))
        else:
            arr = rng.standard_normal(s)
        arrays.append(arr * 0.02)
    return x, cond, g, [p.to(dev) for p in to_port(arrays, hidden)]


def stage_flops(n, d, hidden):
    """Operations per image of one layer: the forward, the recompute (the
    forward without the contract product), and the backward's MLP,
    self-attention and cross-attention sections; full = recompute + the
    three sections. At the flagship's shapes: 3.84, 2.63, 4.86, 2.21 and
    0.61 GFLOP (the JAX probe's analytic accounting)."""
    fwd = (2 * n * d * 3 * d + 4 * n * n * d + 2 * n * d * d + 8 * d * d + 8 * n * d
           + 4 * n * d * hidden + 18 * n * hidden)
    f = dict(fwd=fwd, recompute=fwd - 2 * n * d * hidden,
             mlp=8 * n * d * hidden + 36 * n * hidden,
             self=12 * n * d * d + 8 * n * n * d,
             cross=4 * n * d * d + 8 * d * d + 8 * n * d)
    f["full"] = f["recompute"] + f["mlp"] + f["self"] + f["cross"]
    return f


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hw", type=int, default=16)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--hidden", type=int, default=3072)
    ap.add_argument("--heads", type=int, default=12)
    args = ap.parse_args(argv)
    dev = _probe.get_device(args.device)
    b, hw, heads = args.batch, args.hw, args.heads
    print(f"device={_probe.describe(dev)} batch={b}", flush=True)
    x, cond, g, params = make_inputs(b, hw, args.dim, args.hidden, dev)

    def timed(label, fn):
        before = _probe.launch_counts()
        out = fn()
        leaves = [t for t in (out if isinstance(out, tuple) else (out,))
                  for t in (t if isinstance(t, list) else [t]) if t is not None]
        total = sum(float(t.float().sum()) for t in leaves)
        if not np.isfinite(total):
            raise AssertionError(f"{label}: non-finite output")
        ms = _probe.time_ms(fn, dev, args.reps)
        print(f"{label:>10}: {ms:7.2f} ms", flush=True)
        return dict(ms=ms, out=out, launches=_probe.launches_since(before))

    with torch.no_grad():
        fwd = timed("fwd", lambda: lv.fused_layer_fwd(x, cond, params, heads, hw))
        modes = {mode: timed(mode, lambda m=mode: lv.fused_layer_bwd_variant(
            m, x, cond, g, params, heads, hw)) for mode in MODES}

    ms = {mode: r["ms"] for mode, r in modes.items()}
    full, t_fwd = ms["full"], fwd["ms"]
    flops = stage_flops(hw * hw, args.dim, args.hidden)
    print("\n--- shares (full - ablated) ---")
    for mode in ("no_mlp", "no_cross", "no_self"):
        share = full - ms[mode]
        print(f"{mode[3:]:>6} grads: {share:6.2f} ms ({100 * share / full:4.1f}% of bwd)")
    print(f"recompute  : {ms['recompute']:6.2f} ms "
          f"({100 * ms['recompute'] / full:4.1f}% of bwd)")
    print(f"bwd/fwd    : {full / t_fwd:.2f}x (FLOP ratio {flops['full'] / flops['fwd']:.2f}x)")
    # achieved rate of each stage from its operation count
    rate = "TFLOPS" if dev.type == "cuda" else "TFLOPS (host clock)"
    for label, t in (("fwd", t_fwd), ("full", full), ("recompute", ms["recompute"])):
        print(f"{label:>10}: {flops[label] * b / t / 1e9:6.1f} {rate}")
    return dict(inputs=(x, cond, g, params), fwd=fwd, modes=modes, flops=flops)


if __name__ == "__main__":
    main()
