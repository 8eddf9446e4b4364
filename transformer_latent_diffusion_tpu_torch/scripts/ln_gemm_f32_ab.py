"""A/B of `ln_gemm_f32`'s training modes on the card: the port's
`return_xn` (a LayerNorm product that also returns its float32 rows) and
`w_transposed` (dX = dY W, W read as stored) against the same entry
point, `ltd_ln_gemm_f32`, built from another checkout's `csrc/` (an
earlier version of the kernel).

    python -m transformer_latent_diffusion_tpu_torch.scripts.ln_gemm_f32_ab \\
        --old-csrc build/parent/transformer_latent_diffusion_tpu_torch/csrc

The old source is compiled with the port's nvcc flags into its own
library under `build/ln_gemm_f32_ab/` and called through ctypes with the
port's argument types. Each shape first holds both versions against the
plain version (`fs.ln_gemm_plain`, TF32 off, rel-L2 within 1e-5), the
new one bit-equal over two calls and to the old one (the two compute the
same sums in the same order), then the script times
them in turns old, new, new, old with CUDA events: the seven products of
a 256 px float32 training layer (B = 128, N = 256, D = 768: LN1 -> QKV and
LN2 -> Q with their rows; dX of QKV, Q, the conditioning K/V, expand and
contract), K5's float32 backward products `da` and `dx` at 512 px (B = 64,
1024 tokens), and two forward products (LN1 -> QKV, expand + b1 at the
serving batch 64), whose kernel the training modes do not use. Then one
profile of the seven products gives the device time of each kernel the
new modes launch. `--quick` checks ragged shapes only and times nothing.
`--variants` also builds copies of the current source with parts of the
training modes' work changed or taken out (`EDITS`: the turns, W_lo's
loads, the consumers' A splits by cvt.rna or none, the products; the
outputs of all but "whole" and "cvt split" are not the function's) and times the layer's seven products through each. Prints
ptxas's registers and spills of every build and the card's name and power
limit."""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from transformer_latent_diffusion_tpu_torch.ops import _build
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

OUT = _build.BUILD_ROOT.parent / "ln_gemm_f32_ab"
SOURCE = "ln_gemm_f32.cu"
ENTRY = "ltd_ln_gemm_f32"
# (old, new) text edits of each variant of the current source; each old
# text must occur once
EDITS = {
    "whole": [],
    # the two consumer warpgroups in lockstep: no turns
    "lockstep": [
        ("    if (wg == 1) turn.pass();  // warpgroup 0 runs first\n", ""),
        ("        turn.take();\n", ""),
        ("        turn.pass();\n", ""),
        ("    if (wg == 0) turn.take();  // warpgroup 1's last pass\n", ""),
    ],
    # W_lo never loaded: each stage brings 32 KB from L2, not 48
    "no W_lo load": [
        ("          mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);\n",
         "          mbar_arrive_expect_tx(&full[stage], A_BYTES + W_BYTES);\n"),
        ("          tma_load_2d(st + A_BYTES + W_BYTES, &map_wl, &full[stage], k0, n0);\n"
         "          tma_load_2d(st + A_BYTES + W_BYTES + BOX_BYTES, &map_wl, &full[stage], k0, "
         "n0 + 64);\n", ""),
    ],
    # the consumers' A fragments split by cvt.rna (tf32_frag: the same bits)
    "cvt split": [
        ("          tf32_frag_int(x, fh[kk], fl[kk]);\n", "          tf32_frag(x, fh[kk], fl[kk]);\n"),
    ],
    # the consumers' A fragments taken as they are, not split
    "no A split": [
        ("          tf32_frag_int(x, fh[kk], fl[kk]);\n",
         "          for (int i = 0; i < 4; ++i) fh[kk][i] = fl[kk][i] = __float_as_uint(x[i]);\n"),
    ],
    # no wgmma: the copies, splits, turns, flushes and epilogues alone
    "no products": [
        ("          wgmma_m64n128k8_tf32_rs(part, fl[kk], dh, kk > 0);\n"
         "          wgmma_m64n128k8_tf32_rs(part, fh[kk], dl, 1);\n"
         "          wgmma_m64n128k8_tf32_rs(part, fh[kk], dh, 1);\n", ""),
    ],
}
KERNELS = ("ln_gemm_f32", "split_w_kernel", "ln_rows_kernel")
TF32_FLOP_S = 495e12  # the card's dense TF32 rate at 700 W; 3xTF32 runs at a third
HBM_B_S = 3.35e12
F32 = torch.float32


def variant_source(name: str) -> str:
    """The current source with variant `name`'s edits (each must apply
    exactly once: a changed kernel fails here, not silently)."""
    text = (_build.CSRC / SOURCE).read_text()
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old[:60]!r} occurs {text.count(old)} times in {SOURCE}")
        text = text.replace(old, new)
    return text


def build(builds):
    """{name: (csrc dir, source text or None)} -> {name: (library, ptxas
    lines)}: each source compiled with the port's nvcc flags into a
    library of its own under OUT, all at once."""
    jobs = {}
    for name, (csrc, text) in builds.items():
        d = OUT / name.replace(" ", "_")
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(csrc, d)
        if text is not None:
            (d / SOURCE).write_text(text)
        lib = d / "lib.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(d / SOURCE),
               *_build.LINK_FLAGS]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        fn = getattr(cdll, ENTRY)
        fn.argtypes, fn.restype = list(_build.SIGNATURES[ENTRY]), ctypes.c_int
        libs[name] = (cdll, log.splitlines())
    return libs


def _p(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def lib_call(lib, a, w, bias=None, ln=None, return_xn=False, w_transposed=False):
    """A separately built library's ltd_ln_gemm_f32 with fs.ln_gemm's
    arguments."""
    m, k = a.shape
    n = w.shape[1] if w_transposed else w.shape[0]
    scale, shift = ln if ln is not None else (None, None)
    out = torch.empty((m, n), dtype=F32, device=a.device)
    xn = torch.empty((m, k), dtype=F32, device=a.device) if return_xn else None
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = lib.ltd_ln_gemm_f32(_p(a), _p(scale), _p(shift), _p(w), _p(bias), _p(out), _p(xn), 0,
                              m, n, k, int(w_transposed), stream)
    assert err == 0, f"ltd_ln_gemm_f32 returned {err}"
    return (out, xn) if return_xn else out


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def time_ms(fn, reps: int, warmup: int = 1) -> float:
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


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def bound_ms(m, n, k, xn=False, bias=False) -> float:
    """The least ms of one product: 2 M N K operations at the 3xTF32 rate,
    or a, w and out (and xn, written, and the LayerNorm's 2K and the bias)
    each moved once, the larger."""
    ops = 2 * m * n * k / (TF32_FLOP_S / 3)
    moved = 4 * (m * k * (2 if xn else 1) + n * k + m * n + (2 * k if xn else 0)
                 + (n if bias else 0))
    return 1e3 * max(ops, moved / HBM_B_S)


def check(label, old, new, plain):
    want = _tuple(plain())
    got, again = _tuple(new()), _tuple(new())
    before = _tuple(old()) if old else None
    torch.cuda.synchronize()
    r_new = max(rel_l2(u, w) for u, w in zip(got, want))
    twice = all(torch.equal(u, a) for u, a in zip(got, again))
    r_old = max(rel_l2(u, w) for u, w in zip(before, want)) if before else float("nan")
    same = all(torch.equal(u, b) for u, b in zip(got, before)) if before else None
    print(f"[check] {label}: new rel-L2 {r_new:.3e}, old {r_old:.3e}; new bit-equal twice: "
          f"{twice}; new bit-equal to old: {same}", flush=True)
    return r_new <= 1e-5 and twice and same is not False


def turns(label, old, new, reps, bound):
    t = [time_ms(old, reps), time_ms(new, reps), time_ms(new, reps), time_ms(old, reps)]
    o, n = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    print(f"[time] {label}: old {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} ms "
          f"(old {o:.4f}, new {n:.4f}: {o / n:.3f}x); bound {bound:.4f} ms "
          f"({bound / n:.1%} of it new, {bound / o:.1%} old)", flush=True)
    return o, n


def ptxas(lines, tag):
    name = "?"
    for line in lines:
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif any(f in name for f in KERNELS) and ("registers" in line or "spill" in line
                                                  or "Performance Loss" in line):
            print(f"[ptxas {tag}] {name[:60]}: {line.strip()}", flush=True)


def profile(fn):
    """Device ms of each kernel over one call of fn, by kernel name."""
    from torch.profiler import ProfilerActivity, profile as prof

    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    rows = {}
    for ev in p.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us and ev.count:
            rows[ev.key] = (us / 1e3, ev.count)
    for key, (ms, count) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] {key[:70]}: {ms:.4f} ms over {count} launches", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", type=Path, default=None,
                    help="an earlier checkout's csrc/ (no A/B without it)")
    ap.add_argument("--quick", action="store_true", help="ragged shapes, checks only")
    ap.add_argument("--variants", action="store_true",
                    help="also time copies with parts of the work taken out")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {smi.strip()}", flush=True)
    _build.load_library()
    ptxas((_build.library_path().parent / "build.log").read_text().splitlines(), "new")
    builds = {"old": (args.old_csrc, None)} if args.old_csrc else {}
    if args.variants and not args.quick:
        builds.update({name: (_build.CSRC, variant_source(name)) for name in EDITS})
    libs = build(builds)
    for name, (_, lines) in libs.items():
        ptxas(lines, name)
    old = libs["old"][0] if "old" in libs else None
    g = torch.Generator().manual_seed(0)
    ok = True

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).cuda()

    def modes(m, n, k, lnp):
        """(label, kwargs, a, w) of each training mode and forward mode at (M, N, K)."""
        x, dy = randn(m, k), randn(m, k, std=1e-2)
        w, wt = randn(n, k, std=k ** -0.5), randn(k, n, std=k ** -0.5)
        bias = randn(n, std=0.1)
        return [("return_xn", dict(ln=lnp, return_xn=True), x, w),
                ("w_transposed", dict(w_transposed=True), dy, wt),
                ("forward LN", dict(ln=lnp), x, w),
                ("forward bias", dict(bias=bias), x, w)]

    def runner(a, w, kw, lib=None):
        if lib is not None:
            return lambda: lib_call(lib, a, w, **kw)
        plain = {**kw, "out_dtype": F32}
        return (lambda: fs.ln_gemm(a, w, out_dtype=F32, **kw),
                lambda: fs.ln_gemm_plain(a, w, **plain))

    # ragged shapes: M not a multiple of 128, N = 4 mod 128, K = 8 mod 32
    for m, n, k in ((37, 132, 40), (300, 260, 200), (300, 4, 8), (129, 388, 104)):
        lnp = (1 + randn(k, std=0.1), randn(k, std=0.1))
        for label, kw, a, w in modes(m, n, k, lnp):
            new, plain = runner(a, w, kw)
            prev = runner(a, w, kw, old) if old else None
            ok &= check(f"{label} M={m} N={n} K={k}", prev, new, plain)
    if args.quick:
        print(f"[done] ok={ok}", flush=True)
        return 0 if ok else 1

    d, hidden, m = 768, 3072, 128 * 256
    lnp = (1 + randn(d, std=0.1), randn(d, std=0.1))
    x = randn(m, d)
    ws = {"qkv": randn(3 * d, d, std=d ** -0.5), "q": randn(d, d, std=d ** -0.5),
          "kv": randn(2 * d, d, std=d ** -0.5), "w1": randn(hidden, d, std=d ** -0.5),
          "w2": randn(d, hidden, std=hidden ** -0.5)}
    b1 = randn(hidden, std=0.1)
    # (label, a, w, kwargs): the layer's seven training-mode products
    layer = [("LN1 -> QKV + rows", x, ws["qkv"], dict(ln=lnp, return_xn=True)),
             ("LN2 -> Q + rows", x, ws["q"], dict(ln=lnp, return_xn=True)),
             ("dX of QKV", randn(m, 3 * d, std=1e-2), ws["qkv"], dict(w_transposed=True)),
             ("dX of Q", randn(m, d, std=1e-2), ws["q"], dict(w_transposed=True)),
             ("dX of K/V", randn(2 * 128, 2 * d, std=1e-2), ws["kv"], dict(w_transposed=True)),
             ("dX of expand", randn(m, hidden, std=1e-2), ws["w1"], dict(w_transposed=True)),
             ("dX of contract", randn(m, d, std=1e-2), ws["w2"], dict(w_transposed=True))]
    totals = {}
    for label, a, w, kw in layer:
        new, plain = runner(a, w, kw)
        prev = runner(a, w, kw, old) if old else None
        ok &= check(f"{label} {tuple(a.shape)} x {tuple(w.shape)}", prev, new, plain)
        if old:
            n_out = w.shape[1] if kw.get("w_transposed") else w.shape[0]
            bnd = bound_ms(a.shape[0], n_out, a.shape[1], xn="return_xn" in kw)
            o, n = turns(label, prev, new, 10, bnd)
            mode = "return_xn" if "return_xn" in kw else "w_transposed"
            t = totals.setdefault(mode, [0.0, 0.0, 0.0])
            t[0], t[1], t[2] = t[0] + o, t[1] + n, t[2] + bnd
    for mode, (o, n, bnd) in totals.items():
        print(f"[layer] {mode}: old {o:.4f} ms, new {n:.4f} ms ({o / n:.3f}x); bound "
              f"{bnd:.4f} ms ({bnd / n:.1%} of it new, {bnd / o:.1%} old)", flush=True)
    for name, (lib, _) in libs.items():
        if name == "old":
            continue
        for mode in ("return_xn", "w_transposed"):
            calls = [(a, w, kw) for _, a, w, kw in layer if kw.get(mode)]
            t = time_ms(lambda: [lib_call(lib, a, w, **kw) for a, w, kw in calls], 10)
            bnd = sum(bound_ms(a.shape[0], w.shape[1] if mode == "w_transposed" else w.shape[0],
                               a.shape[1], xn=mode == "return_xn") for a, w, kw in calls)
            print(f"[variant] {name}, {mode} ({len(calls)} products): {t:.4f} ms; bound "
                  f"{bnd:.4f} ms ({bnd / t:.1%} of it)", flush=True)
    try:
        profile(lambda: [fs.ln_gemm(a, w, out_dtype=F32, **kw) for _, a, w, kw in layer])
    except Exception as exc:  # the profiler may see no device time in a sandbox
        print(f"[profile] not measured: {exc!r}", flush=True)
    del layer, x
    torch.cuda.empty_cache()
    # K5's float32 backward at 512 px: da = g W2 and dx = dh W1, B = 64, 1024 tokens
    m5 = 64 * 1024
    for label, a, w in (("K5 da = g W2", randn(m5, d, std=1e-2), ws["w2"]),
                        ("K5 dx = dh W1", randn(m5, hidden, std=1e-2), ws["w1"])):
        kw = dict(w_transposed=True)
        new, plain = runner(a, w, kw)
        prev = runner(a, w, kw, old) if old else None
        ok &= check(f"{label} {tuple(a.shape)} x {tuple(w.shape)}", prev, new, plain)
        if old:
            turns(label, prev, new, 5, bound_ms(m5, w.shape[1], a.shape[1]))
        del a
        torch.cuda.empty_cache()
    # the forward modes (K1 f32 at the serving batch 64): not changed
    mf = 64 * 256
    xf = randn(mf, d)
    for label, w, kw in (("forward LN1 -> QKV", ws["qkv"], dict(ln=lnp)),
                         ("forward expand + b1", ws["w1"], dict(bias=b1))):
        new, plain = runner(xf, w, kw)
        prev = runner(xf, w, kw, old) if old else None
        ok &= check(f"{label} {tuple(xf.shape)} x {tuple(w.shape)}", prev, new, plain)
        if old:
            turns(label, prev, new, 20, bound_ms(mf, w.shape[0], d, bias="bias" in kw))
    print(f"[done] ok={ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
