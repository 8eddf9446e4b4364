"""Does a W8A8 int8 product pair beat bf16 on the card? The port of
scripts/microbench_int8.py (S1).

Times the denoiser's MLP product pair y = (x W1) W2 with x (rows, 768),
W1 768 -> 3072, W2 3072 -> 768 (the JAX probe's x is (256, 256, 768):
65,536 rows): bf16 (`ln_gemm` twice, the hidden state bf16) against W8A8
(`rowquant`, `gemm_i8` with a float32 hidden state, `rowquant`,
`gemm_i8`; per-row dynamic activation scales, per-column weight scales,
the kernels of ops/fused_stack_int8.py), in TFLOP/s; the W8A8 result
against its plain version and against the bf16 one.

Usage: python -m transformer_latent_diffusion_tpu_torch.scripts.microbench_int8
           [--rows 65536] [--reps 20] [--device cuda] [--dim 768] [--hidden 3072]
"""

from __future__ import annotations

import argparse

import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.ops import fused_stack_int8 as q8
from transformer_latent_diffusion_tpu_torch.scripts import _probe


def quant_equal_work(x):
    """rowquant's work (no LayerNorm) in PyTorch calls: the row's |max|,
    its scale, the rounded int8 values."""
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    return torch.round(x * (1.0 / scale)).to(torch.int8), scale


def int_mm_equal_work(xq, rs, wq, cs, bias=None, residual=None,
                      out_dtype=torch.bfloat16):
    """gemm_i8's work in PyTorch calls: `torch._int_mm`, then the row and
    column scales (and the bias, or the float32 residual), as
    `gemm_i8_plain` takes them."""
    deq = torch._int_mm(xq, wq.t()).float() * rs.reshape(-1, 1) * cs.reshape(1, -1)
    if residual is not None:
        out = residual + deq
        return out if bias is None else out + bias.reshape(-1)
    return (deq if bias is None else deq + bias.reshape(-1)).to(out_dtype)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=256 * 256)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--hidden", type=int, default=3072)
    args = ap.parse_args(argv)
    dev = _probe.get_device(args.device)
    m, d, hidden, f32 = args.rows, args.dim, args.hidden, torch.float32
    g = torch.Generator(device="cpu").manual_seed(14)
    x = (torch.randn(m, d, generator=g) * 0.1).to(dev)
    w1 = (torch.randn(hidden, d, generator=g) * 0.02).to(dev, torch.bfloat16)
    w2 = (torch.randn(d, hidden, generator=g) * 0.02).to(dev, torch.bfloat16)
    (w1q, s1), (w2q, s2) = q8.colquant(w1), q8.colquant(w2)
    xb = x.to(torch.bfloat16)

    def w8a8(quant, qmm):
        xq, rs = quant(x)
        hq, rs2 = quant(qmm(xq, rs, w1q, s1, out_dtype=f32))
        return qmm(hq, rs2, w2q, s2)

    def kern():
        return w8a8(q8.rowquant, q8.gemm_i8)

    def plain():
        return w8a8(q8.rowquant_plain, q8.gemm_i8_plain)

    def bf16():
        return fs.ln_gemm(fs.ln_gemm(xb, w1), w2)

    with torch.no_grad():
        before = _probe.launch_counts()
        got = kern()
        launches = _probe.launches_since(before)
        want, ybf = plain(), bf16()
        _probe.sync(dev)
        r, max_abs = _probe.errors(got, want)
        r_bf = _probe.rel_l2(got.float(), ybf.float())
        print(f"[s1] W8A8 pair, kernels vs plain: rel-L2 {r:.2e} (bound "
              f"{_probe.KERNEL_REL_L2}); W8A8 vs bf16: rel-L2 {r_bf:.2e}", flush=True)
        if not (torch.isfinite(got).all() and r < _probe.KERNEL_REL_L2):
            raise AssertionError("S1's W8A8 pair disagrees with its plain version")
        t8, tp = _probe.time_against_plain(kern, plain, dev, args.reps)
        print(f"[s1] s1 W8A8: {t8:.4f} ms, plain {tp:.4f} ms", flush=True)
        t16 = [_probe.time_ms(bf16, dev, args.reps) for _ in range(2)]
        # the same W8A8 pair in PyTorch calls (torch._int_mm runs on the card)
        equal = (_probe.time_ms(lambda: w8a8(quant_equal_work, int_mm_equal_work), dev,
                                args.reps) if dev.type == "cuda" else None)
    flops = 4 * m * d * hidden
    bnd = _probe.bound(m * d * 4 + 2 * hidden * d + 4 * (hidden + d) + m * d * 2, flops,
                       _probe.INT8_TENSOR_OP_S)
    rate = "TOP/s" if dev.type == "cuda" else "TOP/s, host clock"
    print(f"[s1] MLP pair at {m} rows: W8A8 {t8:.4f} ms ({flops / t8 / 1e9:.1f} {rate}, "
          f"bound {bnd[0]:.4f} ms {bnd[1]}), bf16 {sum(t16) / 2:.4f} ms "
          f"({flops / (sum(t16) / 2) / 1e9:.1f} {rate}; runs {t16}); equal work "
          f"(|max|, scale, round, torch._int_mm, scales) "
          f"{'not measured' if equal is None else f'{equal:.4f} ms'}", flush=True)
    return dict(rel_l2=r, max_abs=max_abs, ms=t8, plain_ms=tp, bf16_ms=sum(t16) / 2,
                bound=bnd, launches=launches, equal_work_ms=equal)


if __name__ == "__main__":
    main()
