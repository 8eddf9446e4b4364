"""A/B of the float32 attention backwards on the card: the port's
`self_attention_bwd_f32` (K2/K6 in float32) and `flash_attention_bwd_f32`
(K4a/K4b in float32) against the same functions built from another
checkout's `csrc/` (an earlier version of the kernels).

    python -m transformer_latent_diffusion_tpu_torch.scripts.attn_bwd_f32_ab \\
        --old-csrc build/parent/transformer_latent_diffusion_tpu_torch/csrc

The old sources are compiled with the port's nvcc flags into their own
library under `build/attn_bwd_f32_ab/` and called through ctypes: the
flash pair's entry points as the port's, the self-attention either as the
port's two (`ltd_self_attention_bwd_f32_dq`, `_dkv`) or, before they
existed, as one kernel (`ltd_self_attention_bwd_f32(qkv, dout, dqkv, B,
N, D, H, stream)`, `csrc/attention_bwd_f32.cu`). Each shape first holds
both versions against the plain version (TF32 off, rel-L2) and the new
one bit-equal over two calls, then times them in turns old, new, new, old
with CUDA events at the main path's shapes:
the 256 px layer (B = 128, N = 256, 12 heads), K4a at 512 px (B = 64, N =
1024) and K4b at 1024 px (B = 16, N = 4096). `--quick` checks at small
shapes and times nothing. Prints ptxas's registers and spills of the new
kernels and the card's name and power limit."""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from transformer_latent_diffusion_tpu_torch.ops import _build
from transformer_latent_diffusion_tpu_torch.ops import attention as att
from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv

OUT = _build.BUILD_ROOT.parent / "attn_bwd_f32_ab"
OLD_SOURCES = ("attention_bwd_f32.cu", "flash_attention_bwd_f32.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
# the self-attention's one-kernel entry point, before it ran on the flash pair
ONE_KERNEL = ("ltd_self_attention_bwd_f32", (_P, _P, _P, _I, _I, _I, _I, _P))
ENTRIES = ("ltd_flash_attention_bwd_f32_dq", "ltd_flash_attention_bwd_f32_dkv",
           "ltd_self_attention_bwd_f32_dq", "ltd_self_attention_bwd_f32_dkv")


def build_old(csrc: Path) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libold.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           *(str(csrc / s) for s in OLD_SOURCES if (csrc / s).exists()), *_build.LINK_FLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the old sources:\n{proc.stdout}{proc.stderr}")
    out = ctypes.CDLL(str(lib))
    signatures = {name: _build.SIGNATURES[name] for name in ENTRIES
                  if hasattr(out, name)}
    if not hasattr(out, ENTRIES[2]):
        signatures[ONE_KERNEL[0]] = ONE_KERNEL[1]
    for name, args in signatures.items():
        fn = getattr(out, name)
        fn.argtypes, fn.restype = list(args), ctypes.c_int
    return out


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def old_self(lib, qkv, dout, heads, n):
    dqkv = torch.empty_like(qkv)
    b, d = qkv.shape[0] // n, dout.shape[1]
    if hasattr(lib, ENTRIES[2]):
        stats = torch.empty((2, b, heads, -(-n // 64) * 64), dtype=qkv.dtype, device=qkv.device)
        for fn in (lib.ltd_self_attention_bwd_f32_dq, lib.ltd_self_attention_bwd_f32_dkv):
            assert fn(_p(qkv), _p(dout), _p(stats), _p(dqkv), b, n, heads, _stream()) == 0
    else:
        assert lib.ltd_self_attention_bwd_f32(_p(qkv), _p(dout), _p(dqkv), b, n, d, heads,
                                              _stream()) == 0
    return dqkv


def old_flash(lib, q, k, v, o, g, lse, heads):
    b, n, d = q.shape
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty((b, n, d), dtype=q.dtype, device=q.device) for _ in range(3))
    rows = [t.stride(1) for t in (q, k, v, o, g)]
    assert lib.ltd_flash_attention_bwd_f32_dq(_p(q), _p(k), _p(v), _p(o), _p(g), _p(lse),
                                              _p(delta), _p(dq), b, n, heads, *rows,
                                              _stream()) == 0
    assert lib.ltd_flash_attention_bwd_f32_dkv(_p(q), _p(k), _p(v), _p(g), _p(lse), _p(delta),
                                               _p(dk), _p(dv), b, n, heads, *rows[:3], rows[4],
                                               _stream()) == 0
    return dq, dk, dv


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


def check(label, old, new, plain):
    want = _tuple(plain())
    got, again, before = _tuple(new()), _tuple(new()), _tuple(old()) if old else None
    torch.cuda.synchronize()
    r_new = max(rel_l2(u, w) for u, w in zip(got, want))
    equal = all(torch.equal(u, a) for u, a in zip(got, again))
    r_old = max(rel_l2(u, w) for u, w in zip(before, want)) if before else float("nan")
    print(f"[check] {label}: new rel-L2 {r_new:.3e}, old {r_old:.3e}; new bit-equal twice: "
          f"{equal}", flush=True)
    return r_new <= 1e-5 and equal


def turns(label, old, new, reps, ops):
    t = [time_ms(old, reps), time_ms(new, reps), time_ms(new, reps), time_ms(old, reps)]
    o, n = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    tf = ops / 495e12 * 3 * 1e3  # 3xTF32 at the card's 495 TFLOP/s of TF32
    print(f"[time] {label}: old {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} ms "
          f"(old {o:.4f}, new {n:.4f}: {o / n:.2f}x); 3xTF32 bound of the five products "
          f"{tf:.4f} ms ({tf / n:.1%} of it new, {tf / o:.1%} old)", flush=True)


def ptxas(fragments):
    log = (_build.library_path().parent / "build.log").read_text().splitlines()
    name = "?"
    for line in log:
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif any(f in name for f in fragments) and ("registers" in line or "spill" in line
                                                    or "Performance Loss" in line):
            print(f"[ptxas] {name[:60]}: {line.strip()}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", type=Path, default=None,
                    help="an earlier checkout's csrc/ (no A/B without it)")
    ap.add_argument("--quick", action="store_true", help="small shapes, checks only")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {smi.strip()}", flush=True)
    _build.load_library()
    ptxas(("flash_bwd_f32_kernel",))
    old = build_old(args.old_csrc) if args.old_csrc else None
    g = torch.Generator().manual_seed(0)
    ok = True

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).cuda()

    heads = 2 if args.quick else 12
    d = 64 * heads
    # the self-attention backward: packed qkv (B*N, 3D), dout (B*N, D)
    for b, n, timed in ((2 if args.quick else 16, 144, False), (2 if args.quick else 16, 200, False),
                        (2 if args.quick else 128, 256, not args.quick), (2, 37, False),
                        (1, 1, False)):
        qkv, dout = randn(b * n, 3 * d), randn(b * n, d, std=1e-2)
        new = lambda: lv.self_attention_bwd(qkv, dout, heads, n)  # noqa: E731
        prev = (lambda: old_self(old, qkv, dout, heads, n)) if old else None
        plain = lambda: lv.self_attention_bwd_plain(qkv, dout, heads, n)  # noqa: E731
        ok &= check(f"self_attention_bwd_f32 B={b} N={n} H={heads}", prev, new, plain)
        if timed and old:
            turns(f"self_attention_bwd_f32 B={b} N={n}", prev, new, 20,
                  10 * b * heads * n * n * 64)
        del qkv, dout
    # K4 in float32: strided views of a fused qkv, o and lse from K3's forward
    for b_check, b_time, n in ((2, 64, 1024), (1, 16, 4096), (2, 0, 576)):
        if args.quick:
            b_time = 0
        for b, checking in ((b_check, True), (b_time, False)):
            if b == 0:
                continue
            q, k, v = randn(b, n, 3 * d).chunk(3, dim=-1)
            gr = randn(b, n, d, std=1e-2)
            with torch.no_grad():
                o, lse = att._flash_forward(q, k, v, heads, with_lse=True)
            new = lambda: att.flash_attention_bwd(q, k, v, gr, heads, o=o, lse=lse)  # noqa: E731
            prev = (lambda: old_flash(old, q, k, v, o, gr, lse, heads)) if old else None
            if checking:
                hs = [att._heads(t, heads) for t in (q, k, v, gr)]
                plain = lambda: tuple(att._merge(t) for t in att.attention_bwd_plain(*hs))  # noqa: E731,E501
                ok &= check(f"flash_attention_bwd_f32 B={b} N={n} H={heads}", prev, new, plain)
                del hs
            elif old:
                turns(f"flash_attention_bwd_f32 B={b} N={n}", prev, new, 5,
                      10 * b * heads * n * n * 64)
            del q, k, v, gr, o, lse
            torch.cuda.empty_cache()
    print(f"[done] ok={ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
