"""A/B of the bf16 attention pair (TPU kernel K6) on the card: its route
(`fused_attn_vjp.route_fwd` / `route_bwd`: `csrc/attn_pair.cu` and
`csrc/self_attention.cu`'s X1 body) in turns with the composite of K1's
and K2's kernels that it replaced (`composite_fwd` / `composite_bwd`),
beside autograd through F.layer_norm + F.linear + SDPA.

    python -m transformer_latent_diffusion_tpu_torch.scripts.attn_pair_ab [--quick]

1. Each kernel of the route against its plain version at (B, N) = (128,
   256), (16, 144) and (16, 200) (D = 768, 12 heads; rel-L2 below
   KERNEL_REL_L2), and two launches of it bit-equal; the whole route's
   forward and nine gradients against the plain pair.
2. At (128, 256): the forward and the backward with its recompute, the
   composite and the route timed in turns (composite, route, route,
   composite; CUDA events), and autograd's forward and forward +
   backward, each beside its bound (the products at 989 TFLOP/s).
3. One profile (`torch.profiler`) of a forward and a backward of each:
   the device time of every launch, aten casts and copies included.
4. ptxas's registers and spills for the route's kernels (build.log).

`--quick` runs 1 and 4 only. `--variants` also builds copies of the
route's two sources with parts of the design taken out (`EDITS`; their
outputs are not the pair's) into their own libraries under
`build/attn_pair_ab/`, and profiles the route's forward and backward
through each (the route's wrappers call them in place of the port's
library). Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

import torch
import torch.nn.functional as F

from transformer_latent_diffusion_tpu_torch.ops import _build
from transformer_latent_diffusion_tpu_torch.ops import fused_attn_vjp as k6
from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv

D, HEADS = 768, 12
SHAPES = ((128, 256), (16, 144), (16, 200))
KERNEL_REL_L2 = 1e-2
# the route against the plain pair (chip_smoke.py's LAYER_FWD_REL_L2 /
# LAYER_GRAD_REL_L2)
PAIR_FWD_REL_L2, PAIR_GRAD_REL_L2 = 2e-2, 1e-2
BF16_FLOP_S = 989e12
DEVICE = "cuda"
OUT = _build.BUILD_ROOT.parent / "attn_pair_ab"
SOURCES = ("attn_pair.cu", "self_attention.cu")
# (old, new) text edits of each variant of the current sources; each old
# text must occur once in one of SOURCES
EDITS = {
    # the cross-attention and LayerNorm-backward epilogues' arithmetic taken
    # out (their operands still pass through the ring, LNB's row sums are
    # still exchanged): the products, prologues, loads and stores alone
    "no CROSS / LNB epilogue math": [
        ("          for (int E = e_first; E <= e_last; ++E) {",
         "          for (int E = e_first; E < e_first; ++E) {"),
        ("            for (int jj = 0; jj < 8; jj += 2) {",
         "            for (int jj = 0; jj < 0; jj += 2) {"),
        ("            for (int jc = 0; jc < 8; ++jc) {",
         "            for (int jc = 0; jc < 0; ++jc) {"),
    ],
    # CROSS_FWD's epilogue kept, the element's K/V not loaded ahead of the
    # products (timing only)
    "no CROSS_FWD K/V preload": [
        ("        if constexpr (MODE == CROSS_FWD) {\n          const bf16* kv0",
         "        if constexpr (MODE == CROSS_FWD && false) {\n          const bf16* kv0"),
    ],
}


def ours(name: str) -> bool:
    """The route's own kernels in build.log (self_attention.cu's X1
    instances among them)."""
    return ("pair_gemm_kernel" in name or "pair_dkv_kernel" in name
            or ("self_attention_kernel" in name and "Lb1E" in name))


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


def pair_inputs(gen, b, n):
    """x, cond, the upstream gradient g (bf16) and the seven parameters
    (bf16 projections (out, in), float32 LayerNorm) of one pair."""
    dev, bf = torch.device(DEVICE), torch.bfloat16

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=gen) * scale

    params = [1 + rnd(D, scale=0.1), rnd(D, scale=0.1), rnd(3 * D, D, scale=D ** -0.5),
              1 + rnd(D, scale=0.1), rnd(D, scale=0.1), rnd(D, D, scale=D ** -0.5),
              rnd(2 * D, D, scale=D ** -0.5)]
    params = [p.to(dev, bf if p.dim() == 2 else torch.float32) for p in params]
    x, cond = rnd(b, n, D).to(dev, bf), rnd(b, 2, D).to(dev, bf)
    g = rnd(b, n, D, scale=1e-3).to(dev, bf)
    return x, cond, g, params


def pair_flops(b, n):
    """(forward, backward with its recompute) operations, chip_smoke.py's
    count: the three products, the self-attention's two; the backward adds
    dX and dW of the products and the attention backward's five."""
    m = b * n
    products = 2 * m * D * 3 * D + 2 * m * D * D + 2 * 2 * b * D * 2 * D
    attention = 4 * b * HEADS * n * n * 64
    fwd = products + attention
    return fwd, fwd + 2 * products + 10 * b * HEADS * n * n * 64


def sdpa_pair(x, cond, params):
    """The pair as F.layer_norm + F.linear + SDPA (a yardstick)."""
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


def kernel_cases(x, cond, g, params, n, heads):
    """{name: (kernel call, plain call)} of the route's kernels, on the
    inputs the route gives them (each taken from the plain versions)."""
    ln1s, ln1b, wqkv, ln2s, ln2b, wq, wkv = params
    b, _, d = x.shape
    m = b * n
    xr, gr = x.reshape(m, d), g.reshape(m, d)
    qkv, _, stats1 = k6.pair_qkv_plain(xr, ln1s, ln1b, wqkv)
    kv = (cond.reshape(2 * b, d).float() @ wkv.float().T).to(torch.bfloat16)
    x1 = k6.self_attention_x1_plain(qkv, xr, heads, n)
    dqc, _, stats2, part = k6.pair_cross_bwd_plain(x1, ln2s, ln2b, wq, kv, gr, heads, n)
    dx1, _ = k6.pair_ln_bwd_plain(dqc, wq, x1, stats2, ln2s, gr, torch.float32)
    dqkv = lv.self_attention_bwd_plain(qkv, dx1, heads, n)
    rows = -(-m // k6.BM)

    def ln_bwd(kernel, *args):
        part_ = torch.zeros((rows, 2 * d), dtype=torch.float32, device=x.device)
        if kernel:
            return k6.pair_ln_bwd(*args, part_, 0), part_
        return k6.pair_ln_bwd_plain(*args)

    ln2 = (dqc, wq, x1, stats2, ln2s, gr, torch.float32)
    ln1 = (dqkv, wqkv, xr, stats1, ln1s, dx1, torch.bfloat16)
    return {
        "pair_qkv": (lambda: k6.pair_qkv(xr, ln1s, ln1b, wqkv, keep=True),
                     lambda: k6.pair_qkv_plain(xr, ln1s, ln1b, wqkv)),
        "self_attention_x1": (lambda: k6.self_attention_x1(qkv, xr, heads, n),
                              lambda: k6.self_attention_x1_plain(qkv, xr, heads, n)),
        "pair_cross_fwd": (lambda: k6.pair_cross_fwd(x1, ln2s, ln2b, wq, kv, heads, n),
                           lambda: k6.pair_cross_fwd_plain(x1, ln2s, ln2b, wq, kv, heads, n)),
        "pair_cross_bwd + pair_dkv": (
            lambda: k6.pair_cross_bwd(x1, ln2s, ln2b, wq, kv, gr, heads, n),
            lambda: (*k6.pair_cross_bwd_plain(x1, ln2s, ln2b, wq, kv, gr, heads, n)[:3],
                     k6.pair_dkv_plain(part, b, n, d))),
        "pair_ln_bwd (LN2)": (lambda: ln_bwd(True, *ln2), lambda: ln_bwd(False, *ln2)),
        "pair_ln_bwd (LN1)": (lambda: ln_bwd(True, *ln1), lambda: ln_bwd(False, *ln1)),
    }


def check_kernels(gen, log):
    """Part 1; returns the worst rel-L2 of each kernel and of the pair."""
    worst = {}
    for b, n in SHAPES:
        x, cond, g, params = pair_inputs(gen, b, n)
        for name, (kern, plain) in kernel_cases(x, cond, g, params, n, HEADS).items():
            got, again, want = kern(), kern(), plain()
            got, again, want = (t if isinstance(t, tuple) else (t,) for t in (got, again, want))
            rels = [rel_l2(u.float(), w.float()) for u, w in zip(got, want)]
            same = all(torch.equal(u, v) for u, v in zip(got, again))
            err = max(float((u.float() - w.float()).abs().max()) for u, w in zip(got, want))
            log(f"[kernels] {name} at B = {b}, N = {n}: rel-L2 per output "
                f"{' '.join(f'{r:.2e}' for r in rels)} (bound {KERNEL_REL_L2}), max-abs "
                f"{err:.3e}, two launches bit-equal: {same}")
            if not (max(rels) < KERNEL_REL_L2 and same):
                raise AssertionError(f"{name} at N = {n} disagrees with its plain version")
            worst[name] = max(worst.get(name, 0.0), max(rels))
        out = k6.route_fwd(x, cond, params, HEADS)
        want = k6.fused_attention_pair_fwd_plain(x, cond, *params, HEADS)
        r = rel_l2(out.float() - x.float(), want.float() - x.float())
        grads = k6.route_bwd(x, cond, g, params, HEADS)
        gwant = k6.fused_attention_pair_bwd_plain(x, cond, g, *params, HEADS)
        got = (grads[0], grads[1], *grads[2])
        rels = [rel_l2(u.float().reshape(w.shape), w.float()) for u, w in zip(got, gwant)]
        log(f"[kernels] the route at B = {b}, N = {n}: forward rel-L2 of the update {r:.2e} "
            f"(bound {PAIR_FWD_REL_L2}); nine gradients {' '.join(f'{v:.2e}' for v in rels)} "
            f"(bound {PAIR_GRAD_REL_L2})")
        if not (r < PAIR_FWD_REL_L2 and max(rels) < PAIR_GRAD_REL_L2):
            raise AssertionError(f"the route at N = {n} disagrees with the plain pair")
    return worst


def breakdown(fn, label, log):
    """One call of fn under the profiler: every device kernel's time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    log(f"[breakdown] {label}: {total:.4f} ms of device time in {sum(r[1] for r in rows)} "
        f"launches: " + "; ".join(f"{k[:60]} x{c} {ms:.4f}" for ms, c, k in rows))
    return rows


def ptxas(log):
    """Registers and spills of the route's kernels (the build's ptxas -v)."""
    name, spills = "?", []
    for line in (_build.library_path().parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif not ours(name):
            continue
        elif "Performance Loss" in line:
            spills.append(f"{name}: {line.strip()}")
        elif "spill stores" in line:
            if "0 bytes spill stores, 0 bytes spill loads" not in line:
                spills.append(f"{name}: {line.strip()}")
            log(f"[ptxas] {name}: {line.strip()}")
        elif "Used" in line and "registers" in line:
            log(f"[ptxas] {name}: {line.split('Used')[1].split(',')[0].strip()}")
    return spills


def variant_library(name):
    """The route's sources with EDITS[name] applied, built into their own
    library (ctypes, the port's SIGNATURES)."""
    out = OUT / name.replace(" ", "_").replace("/", "")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    for old, new in EDITS[name]:
        hits = [src for src in SOURCES if (out / src).read_text().count(old) == 1]
        if len(hits) != 1:
            raise ValueError(f"{name}: edit {old[:60]!r} matches {len(hits)} sources")
        path = out / hits[0]
        path.write_text(path.read_text().replace(old, new))
    lib_path = out / "libvariant.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
           *(str(out / src) for src in SOURCES), *_build.LINK_FLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for entry, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, entry):
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def profile_variants(calls, log):
    """Each EDITS variant's kernels under the route's forward and backward."""
    real = k6.load_library
    try:
        for name in EDITS:
            lib = variant_library(name)
            k6.load_library = lambda lib=lib: lib
            for what, (_, new) in calls.items():
                breakdown(new, f"variant '{name}', route {what}", log)
    finally:
        k6.load_library = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="check the kernels only")
    ap.add_argument("--variants", action="store_true",
                    help="also profile the route through each EDITS variant")
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[env] {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    _build.load_library()
    spills = ptxas(log)
    gen = torch.Generator().manual_seed(0)
    worst = check_kernels(gen, log)
    log(f"[kernels] worst rel-L2: {worst}")
    if args.quick:
        return report(spills, log)

    b, n = SHAPES[0]
    x, cond, g, params = pair_inputs(gen, b, n)
    calls = {
        "forward": (lambda: k6.composite_fwd(x, cond, params, HEADS),
                    lambda: k6.route_fwd(x, cond, params, HEADS)),
        "backward": (lambda: k6.composite_bwd(x, cond, g, params, HEADS),
                     lambda: k6.route_bwd(x, cond, g, params, HEADS)),
    }
    fwd_ops, bwd_ops = pair_flops(b, n)
    times = {}
    for what, (old, new) in calls.items():
        t = [time_ms(old), time_ms(new), time_ms(new), time_ms(old)]
        times[what] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2)
        ops = fwd_ops if what == "forward" else bwd_ops
        log(f"[ab] {what} at B = {b}, N = {n}: composite {times[what][0]:.4f} ms, route "
            f"{times[what][1]:.4f} ms (runs {' '.join(f'{v:.4f}' for v in t)}); bound "
            f"{ops / BF16_FLOP_S * 1e3:.4f} ms ({ops / 1e9:.1f} GFLOP), the route at "
            f"{ops / BF16_FLOP_S * 1e3 / times[what][1] * 100:.1f}%")
    leaves = [t.clone().requires_grad_(True) for t in (x, cond, *params)]
    with torch.no_grad():
        sdpa_fwd = time_ms(lambda: sdpa_pair(x, cond, params))
    sdpa_both = time_ms(lambda: sdpa_pair(leaves[0], leaves[1], leaves[2:]).backward(g))
    both = times["forward"][1] + times["backward"][1]
    log(f"[ab] autograd through F.layer_norm + F.linear + SDPA: forward {sdpa_fwd:.4f} ms, "
        f"forward + backward {sdpa_both:.4f} ms; the route {times['forward'][1]:.4f} / "
        f"{both:.4f} ms, the composite {times['forward'][0]:.4f} / "
        f"{times['forward'][0] + times['backward'][0]:.4f} ms")
    for what, (old, new) in calls.items():
        breakdown(old, f"composite {what}", log)
        breakdown(new, f"route {what}", log)
    if args.variants:
        profile_variants(calls, log)
    log(f"[env] {smi}")
    return report(spills, log)


def report(spills, log) -> int:
    """1 (after the measurements) if ptxas spilled or serialised one of the
    route's kernels."""
    for line in spills:
        log(f"[ptxas] spilled or serialised: {line}")
    return 1 if spills else 0


if __name__ == "__main__":
    raise SystemExit(main())
