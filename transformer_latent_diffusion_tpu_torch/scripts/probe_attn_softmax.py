"""Flash-attention softmax variants at 4096 tokens (same-process A/B), on
the card: the port of scripts/probe_attn_softmax.py (S3).

The same attention in four forms, each a template instantiation of the
flash-attention kernel (csrc/flash_attention.cu, `flash_attention_variant`
in ops/attention.py):
  exp2     exp(x) == exp2(x * log2 e): log2 e folded into the score scale
  postdiv  (e @ v) / z instead of (e / z) @ v: e rounded to bf16 and O
           divided at the end (the port's K3 is exp2,postdiv), where prediv
           normalises each p in float32 before rounding it (the TPU K3's
           rounding), which here takes a second pass over the keys

The inputs are the JAX probe's (B, H, N, 64) heads, handed to the kernel
as (B*H, N, 64) rows of one head each (a view, no copy). `--sass` also
prints what each form's kernel compiled to (cuobjdump -sass on the built
library: the SFU exponentials, reciprocals, FMAs and `wgmma` tensor-core
products of each instantiation).

Usage: python -m transformer_latent_diffusion_tpu_torch.scripts.probe_attn_softmax
           [--batch 4] [--heads 12] [--tokens 4096] [--reps 20]
           [--device cuda] [--sass]
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess

import torch

from transformer_latent_diffusion_tpu_torch.ops import attention as att
from transformer_latent_diffusion_tpu_torch.scripts import _probe

HEAD_DIM = 64
# (tag, use_exp2, postdiv), in the JAX probe's order; the first is the
# reference of the maxdiff column
VARIANTS = (("exp,prediv", False, False),
            ("exp2,prediv", True, False),
            ("exp,postdiv", False, True),
            ("exp2,postdiv (K3)", True, True))
SASS_OPS = ("MUFU.EX2", "MUFU.RCP", "FFMA", "FMUL", "FADD", "HGMMA")


def make_inputs(batch, heads, tokens, dev, seed=0):
    """q, k, v: (B, H, N, 64) bf16 standard normals from a seed."""
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(batch, heads, tokens, HEAD_DIM, generator=gen)
                 .to(dev, torch.bfloat16) for _ in range(3))


def _rows(fn, q, k, v, use_exp2, postdiv):
    b, h, n, dh = q.shape
    rows = [t.reshape(b * h, t.shape[2], dh) for t in (q, k, v)]
    return fn(*rows, 1, use_exp2, postdiv).reshape(b, h, n, dh)


def attn(q, k, v, use_exp2, postdiv):
    """The probe's `attn` through the kernel: (B, H, N, 64) -> the same."""
    return _rows(att.flash_attention_variant, q, k, v, use_exp2, postdiv)


def attn_plain(q, k, v, use_exp2, postdiv):
    """Its plain version (`attention_variant_plain`)."""
    return _rows(att.attention_variant_plain, q, k, v, use_exp2, postdiv)


def sass_summary():
    """{(use_exp2, prediv): {opcode: count}} of the flash-attention
    kernel's instantiations in the built library (cuobjdump -sass)."""
    from transformer_latent_diffusion_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True,
                          text=True, check=True).stdout
    counts, current = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_attention_kernelILb(\d)ELb(\d)E", line)
            current = (m.group(1) == "1", m.group(2) == "1") if m else None
            if current is not None:
                counts[current] = collections.Counter()
        elif current is not None:
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                op = m.group(1)
                counts[current]["instructions"] += 1
                for name in SASS_OPS:
                    if op.startswith(name):
                        counts[current][name] += 1
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--tokens", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sass", action="store_true",
                    help="also print each form's compiled instruction counts")
    args = ap.parse_args(argv)
    dev = _probe.get_device(args.device)
    print(f"device={_probe.describe(dev)} batch={args.batch} heads={args.heads} "
          f"tokens={args.tokens}", flush=True)
    q, k, v = make_inputs(args.batch, args.heads, args.tokens, dev)
    results, ref = {}, None
    with torch.no_grad():
        for tag, use_exp2, postdiv in VARIANTS:
            before = _probe.launch_counts()
            out = attn(q, k, v, use_exp2, postdiv)
            ms = _probe.time_ms(lambda: attn(q, k, v, use_exp2, postdiv), dev, args.reps)
            launches = _probe.launches_since(before)
            if ref is None:
                ref = out
            d = float((out.float() - ref.float()).abs().max())
            print(f"{tag:24s} {ms:7.3f} ms  maxdiff {d:.1e}", flush=True)
            results[tag] = dict(use_exp2=use_exp2, postdiv=postdiv, ms=ms, out=out,
                                launches=launches)
    if args.sass:
        for (use_exp2, prediv), c in sorted(sass_summary().items()):
            form = f"{'exp2' if use_exp2 else 'exp'},{'prediv' if prediv else 'postdiv'}"
            print(f"sass {form:14s} " + " ".join(
                f"{name}={c[name]}" for name in ("instructions",) + SASS_OPS), flush=True)
    return dict(inputs=(q, k, v), variants=results)


if __name__ == "__main__":
    main()
