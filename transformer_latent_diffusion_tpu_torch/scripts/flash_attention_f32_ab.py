"""A/B of K3's float32 body, `flash_attention_f32`, on the card: the
port's `ltd_flash_attention_f32` against the same entry point built from
another checkout's `csrc/` (an earlier version of the kernel).

    python -m transformer_latent_diffusion_tpu_torch.scripts.flash_attention_f32_ab \\
        --old-csrc build/parent/transformer_latent_diffusion_tpu_torch/csrc

The old source is compiled with the port's nvcc flags into its own
library under `build/flash_attention_f32_ab/` and called through ctypes
with the port's argument types. Both versions are first held against the
plain version (`attention.multi_head_attention` in float32, TF32 off,
rel-L2 within 1e-5) at `chip_smoke.F32_FLASH_CASES` and
`chip_smoke.F32_FLASH_RAGGED` (Nq, Nk on both sides of the kernels' 64-key
chunks and 128-query items, Nq != Nk among them), with and without the
log-sum-exp: o with lse bit-equal to o without, lse within rel-L2 1e-6 of
torch.logsumexp, each bit-equal over two calls. Then the script times them in turns old, new,
new, old with CUDA events at N = 1024 B = 64 (512 px), N = 4096 B = 8
(1024 px) and N = 256 B = 64 (the float32 "mlp" / "moe" models at 256 px),
12 heads, beside the bound (4 N^2 64 operations per (image, head) at the
3xTF32 rate, or q, k, v and o moved once, the larger), SDPA in float32
(TF32 off) on the same q, k, v and the plain version. `--quick` checks
only. `--variants` also builds copies of the current source with one lever
taken out at a time (`EDITS`: the turns, P's split once a chunk, the K/V
split form and the rings' depths, the exponentials; and the products or
the splits themselves) and times each at the three shapes, printing its rel-L2 to the
plain version ("no products" and "no splits" compute no attention). Prints ptxas's
registers and spills of every build and the card's name and power limit."""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from transformer_latent_diffusion_tpu_torch.ops import _build
from transformer_latent_diffusion_tpu_torch.ops import attention as att

OUT = _build.BUILD_ROOT.parent / "flash_attention_f32_ab"
SOURCE = "flash_attention_f32.cu"
ENTRY = "ltd_flash_attention_f32"
# (old, new) text edits of each variant of the current source; each old
# text must occur once
EDITS = {
    "whole": [],
    # no turns: the two consumer warpgroups issue their runs as they come
    "no turns": [
        ("\n  turn.take();\n", "\n"),
        ("\n  turn.pass();\n", "\n"),
        ("    if (wg == 1) turn.pass();  // warpgroup 0 runs first\n", ""),
        ("    if (wg == 0) turn.take();  // warpgroup 1's last pass\n", ""),
    ],
    # P V split one K step at a time, each step waited for before the next
    # is split (f32_chunk.cuh's chunk_products, cvt.rna), the turn held
    # through the run
    "per-step P split": [
        ("      run(part, ph, pl, next_chunk(), turn);\n",
         "      {\n"
         "        const unsigned char* vc = next_chunk();\n"
         "        turn.take();\n"
         "        chunk_products<true>(part, vc, vc + PART_BYTES, [&](int kk, float (&x)[4]) {\n"
         "          x[0] = s[4 * kk];\n"
         "          x[1] = s[4 * kk + 2];\n"
         "          x[2] = s[4 * kk + 1];\n"
         "          x[3] = s[4 * kk + 3];\n"
         "        });\n"
         "        turn.pass();\n"
         "      }\n"),
    ],
    # K and V split by f32_chunk.cuh's split_chunk on three warps: hi
    # rounded (tf32_split_fast), V^T in units of 4 keys x 2 columns
    "fast splitters": [
        ("split_as_stored<SPLIT_THREADS>(raw + rs * RAW_BYTES,",
         "if (sid < SPLITTERS) split_chunk<true>(raw + rs * RAW_BYTES,"),
    ],
    # the same by cvt.rna (tf32_split: both parts rounded)
    "cvt splitters": [
        ("split_as_stored<SPLIT_THREADS>(raw + rs * RAW_BYTES,",
         "if (sid < SPLITTERS) split_chunk<false>(raw + rs * RAW_BYTES,"),
    ],
    # this split on three warps of the four, as the producer warp's other
    # three warps split when one thread only starts the copies
    "3 splitter warps": [
        ("split_as_stored<SPLIT_THREADS>(raw + rs * RAW_BYTES, hi, hi + PART_BYTES, p & 1, sid);",
         "if (sid >= 32) split_as_stored<SPLITTERS>(raw + rs * RAW_BYTES, hi, hi + PART_BYTES, "
         "p & 1, sid - 32);"),
    ],
    # no splits at all: the split slots keep what they held (a bound on
    # what the splitters cost)
    "no splits": [
        ("split_as_stored<SPLIT_THREADS>(raw + rs * RAW_BYTES, hi, hi + PART_BYTES, p & 1, sid);",
         ""),
    ],
    # a shallower raw ring, a deeper split ring (225 KB)
    "ring 2 + 6": [
        ("constexpr int RAW_SLOTS = 4, SPLIT_SLOTS = 4;",
         "constexpr int RAW_SLOTS = 2, SPLIT_SLOTS = 6;"),
    ],
    # a deeper raw ring (225 KB)
    "ring 6 + 4": [
        ("constexpr int RAW_SLOTS = 4, SPLIT_SLOTS = 4;",
         "constexpr int RAW_SLOTS = 6, SPLIT_SLOTS = 4;"),
    ],
    # the exponentials by expf (its range reduction) in place of one MUFU.EX2
    "expf": [
        ("{ return exp2_approx(x); }", "{ return expf(x * LN2); }"),
    ],
    # no wgmma: the rings, splits, turns, softmax and stores alone
    "no products": [
        ("    if (kk == 0) {\n"
         "      wgmma_m64n64k8_tf32_rs_first(d, al[0], dh);\n"
         "    } else {\n"
         "      wgmma_m64n64k8_tf32_rs(d, al[kk], dh, 1);\n"
         "    }\n"
         "    wgmma_m64n64k8_tf32_rs(d, ah[kk], dl, 1);\n"
         "    wgmma_m64n64k8_tf32_rs(d, ah[kk], dh, 1);\n",
         "    if (kk == 0)\n"
         "      for (int i = 0; i < 32; ++i) d[i] = __uint_as_float(ah[0][0] ^ al[0][0]);\n"
         "    asm volatile(\"\" ::\"l\"(dh), \"l\"(dl));\n"),
    ],
}
KERNELS = ("flash_attention_f32_kernel",)
# (label, images, tokens) of the timed shapes, 12 heads
SHAPES = (("512 px", 64, 1024), ("1024 px", 8, 4096), ("256 px FFN models", 64, 256))
HEADS = 12
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
        d = OUT / name.replace(" ", "_").replace("+", "p")
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


def lib_call(lib, q, k, v, heads, with_lse=False):
    """A separately built library's ltd_flash_attention_f32 with
    `attention._flash_forward`'s arguments: (out, lse or None)."""
    b, nq, d = q.shape
    out = torch.empty((b, nq, d), dtype=F32, device=q.device)
    lse = torch.empty((b, heads, nq), dtype=F32, device=q.device) if with_lse else None
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = getattr(lib, ENTRY)(_p(q), _p(k), _p(v), _p(out), _p(lse), b, nq, k.shape[1], heads,
                              q.stride(1), k.stride(1), v.stride(1), stream)
    assert err == 0, f"{ENTRY} returned {err}"
    return out, lse


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


def bound_ms(b, nq, nk, heads) -> float:
    """The least ms of one call: 4 Nq Nk 64 operations per (image, head) at
    the 3xTF32 rate, or q, k, v read and o written once, the larger."""
    ops = 4 * b * heads * nq * nk * 64 / (TF32_FLOP_S / 3)
    moved = 4 * 64 * heads * b * (2 * nq + 2 * nk)
    return 1e3 * max(ops, moved / HBM_B_S)


def qkv(g, b, nq, nk, heads):
    """q, k, v as the model hands them over: strided column views of a
    fused QKV (self-shaped) or of a q and a fused KV (Nq != Nk)."""
    d = 64 * heads
    if nq == nk:
        return torch.randn(b, nq, 3 * d, generator=g).cuda().chunk(3, dim=-1)
    q = torch.randn(b, nq, d, generator=g).cuda()
    k, v = torch.randn(b, nk, 2 * d, generator=g).cuda().chunk(2, dim=-1)
    return q, k, v


def check(label, q, k, v, heads, lib=None):
    """The body (the port's, or `lib`'s) against the plain version, with and
    without lse; True if it holds."""
    call = ((lambda w: att._flash_forward(q, k, v, heads, with_lse=w)) if lib is None
            else (lambda w: lib_call(lib, q, k, v, heads, with_lse=w)))
    want = att.multi_head_attention(q, k, v, heads)
    (o, _), (o2, lse) = call(False), call(True)
    again = call(False)[0]
    s = att._heads(q, heads).double() @ att._heads(k, heads).double().transpose(-1, -2)
    r, r_lse = rel_l2(o, want), rel_l2(lse, torch.logsumexp(s / 8, -1))
    del s
    twice, with_lse = torch.equal(o, again), torch.equal(o, o2)
    print(f"[check] {label}: rel-L2 {r:.3e}; lse rel-L2 {r_lse:.3e}; bit-equal twice: {twice}; "
          f"o with lse bit-equal: {with_lse}", flush=True)
    return r <= 1e-5 and r_lse <= 1e-6 and twice and with_lse


def ptxas(lines, tag):
    name = "?"
    for line in lines:
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif any(f in name for f in KERNELS) and ("registers" in line or "spill" in line
                                                  or "Performance Loss" in line):
            print(f"[ptxas {tag}] {name[:60]}: {line.strip()}", flush=True)
        elif "Performance Loss" in line and any(f in line for f in KERNELS):
            print(f"[ptxas {tag}] {line.strip()}", flush=True)


def main(argv=None):
    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", type=Path, default=None,
                    help="an earlier checkout's csrc/ (no A/B without it)")
    ap.add_argument("--quick", action="store_true", help="checks only")
    ap.add_argument("--variants", action="store_true",
                    help="also time copies with one lever taken out at a time")
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
    with torch.no_grad():
        cases = [(b, n, n, h) for b, n, h in chip_smoke.F32_FLASH_CASES]
        cases += [(2, nq, nk, 2) for nq, nk in chip_smoke.F32_FLASH_RAGGED]
        for b, nq, nk, heads in cases:
            q, k, v = qkv(g, b, nq, nk, heads)
            label = f"B={b} Nq={nq} Nk={nk} heads={heads}"
            ok &= check(f"new {label}", q, k, v, heads)
            if old is not None:
                ok &= check(f"old {label}", q, k, v, heads, old)
            del q, k, v
            torch.cuda.empty_cache()
        if args.quick:
            print(f"[done] ok={ok}", flush=True)
            return 0 if ok else 1
        for label, b, n in SHAPES:
            q, k, v = qkv(g, b, n, n, HEADS)
            bnd = bound_ms(b, n, n, HEADS)
            reps = 50 if n <= 256 else 10
            new = lambda: att._flash_forward(q, k, v, HEADS)  # noqa: E731
            if old is not None:
                prev = lambda: lib_call(old, q, k, v, HEADS)  # noqa: E731
                t = [time_ms(prev, reps), time_ms(new, reps), time_ms(new, reps),
                     time_ms(prev, reps)]
                o_, n_ = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
                print(f"[time] {label} B={b} N={n}: old {t[0]:.4f} / {t[3]:.4f} ms, new "
                      f"{t[1]:.4f} / {t[2]:.4f} ms (old {o_:.4f}, new {n_:.4f}: {o_ / n_:.3f}x); "
                      f"bound {bnd:.4f} ms ({bnd / n_:.1%} of it new, {bnd / o_:.1%} old)",
                      flush=True)
            else:
                t = time_ms(new, reps)
                print(f"[time] {label} B={b} N={n}: new {t:.4f} ms; bound {bnd:.4f} ms "
                      f"({bnd / t:.1%} of it)", flush=True)
            def heads(t):
                return t.reshape(b, n, HEADS, 64).transpose(1, 2)

            sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                heads(q), heads(k), heads(v)), reps)
            plain = time_ms(lambda: att.multi_head_attention(q, k, v, HEADS), max(reps // 5, 2))
            print(f"[time] {label} B={b} N={n}: SDPA float32 (TF32 off) {sdpa:.4f} ms, "
                  f"plain {plain:.4f} ms", flush=True)
            if args.variants:
                want = att.multi_head_attention(q, k, v, HEADS)
                for name, (lib, _) in libs.items():
                    if name == "old":
                        continue
                    call = lambda: lib_call(lib, q, k, v, HEADS)  # noqa: E731
                    r = rel_l2(call()[0], want)
                    t = time_ms(call, reps)
                    print(f"[variant] {name}, {label} B={b} N={n}: {t:.4f} ms; bound {bnd:.4f} "
                          f"ms ({bnd / t:.1%} of it); rel-L2 {r:.3e}", flush=True)
                del want
            del q, k, v
            torch.cuda.empty_cache()
    print(f"[done] ok={ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
