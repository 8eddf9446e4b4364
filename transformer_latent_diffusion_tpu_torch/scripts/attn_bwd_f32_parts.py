"""Where the float32 attention backward's kernels spend their time on the
card: `csrc/flash_attention_bwd_f32.cu` (K4a/K4b in float32, and
`self_attention_bwd_f32` on the same kernels) with parts of its work taken
out.

Builds copies of the source under `build/attn_bwd_f32_parts/<variant>/`:
- "whole": the kernel as it is;
- "no products": every run of `wgmma` removed (the consumers still wait
  for the split chunks, do their exponentials and hand the turns on), so
  the time is the producer warpgroup's copies and splits and the rest;
- "no splits": the producer warps' conversions removed (they still wait
  for and publish every slot), so the time is the consumers' products and
  exponentials and the copies;
and times the dq and dk/dv kernels of each at the main path's shapes: the
self-attention at the 256 px layer (B = 128, N = 256, 12 heads), K4a at
512 px (B = 64, N = 1024) and K4b at 1024 px (B = 16, N = 4096), on
random inputs (the variants' outputs are not the function's). Prints the
card's name and power limit and ptxas's registers and spills of each copy.

    python -m transformer_latent_diffusion_tpu_torch.scripts.attn_bwd_f32_parts

Needs a card and the CUDA toolkit's nvcc (~40 s of command).
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from typing import Dict, List, Tuple

import torch

from transformer_latent_diffusion_tpu_torch.ops import _build

OUT = _build.BUILD_ROOT.parent / "attn_bwd_f32_parts"
SOURCE = "flash_attention_bwd_f32.cu"
# (old, new) text edits of each variant; each old text must occur once
EDITS: Dict[str, List[Tuple[str, str]]] = {
    "whole": [],
    "no products": [
        ("  constexpr int STEPS = 8 * NP;\n",
         "  constexpr int STEPS = 8 * NP;\n  if (true) {\n    turn.pass();\n    return;\n  }\n"),
        ("  uint32_t fh[2][4], fl[2][4];\n  float x[4];\n  f1(0, x);\n",
         "  if (true) {\n    turn.pass();\n    return;\n  }\n"
         "  uint32_t fh[2][4], fl[2][4];\n  float x[4];\n  f1(0, x);\n"),
    ],
    "no splits": [
        ("        split_chunk<true>(src, hi, hi + PART_BYTES, transposed, sid);\n", ""),
    ],
}
ENTRIES = ("ltd_flash_attention_bwd_f32_dq", "ltd_flash_attention_bwd_f32_dkv",
           "ltd_self_attention_bwd_f32_dq", "ltd_self_attention_bwd_f32_dkv")


def variant_source(name: str) -> str:
    """The kernel's source with variant `name`'s edits (each must apply
    exactly once: a changed kernel fails here, not silently)."""
    text = (_build.CSRC / SOURCE).read_text()
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old[:60]!r} occurs {text.count(old)} times in {SOURCE}")
        text = text.replace(old, new)
    return text


def build(names) -> Dict[str, ctypes.CDLL]:
    jobs = {}
    for name in names:
        d = OUT / name.replace(" ", "_")
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(_build.CSRC, d)
        (d / SOURCE).write_text(variant_source(name))
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
        for line in log.splitlines():
            if "spill" in line or "registers" in line:
                print(f"[ptxas] {name}: {line.strip()}", flush=True)
        cdll = ctypes.CDLL(str(lib))
        for fn in ENTRIES:
            f = getattr(cdll, fn)
            f.argtypes, f.restype = list(_build.SIGNATURES[fn]), ctypes.c_int
        libs[name] = cdll
    return libs


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", default=list(EDITS))
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    libs = build(args.variants)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    heads = 12
    d = 64 * heads
    g = torch.Generator().manual_seed(0)

    def p(t):
        return ctypes.c_void_p(t.data_ptr())

    def check(err):
        assert err == 0, err

    for b, n in ((64, 1024), (16, 4096)):
        q, k, v = torch.randn(b, n, 3 * d, generator=g).cuda().chunk(3, -1)
        gr = torch.randn(b, n, d, generator=g).cuda() * 0.01
        o = torch.randn(b, n, d, generator=g).cuda()
        lse = torch.randn(b, heads, n, generator=g).cuda().abs() + 5
        delta = torch.empty_like(lse)
        dq, dk, dv = (torch.empty(b, n, d, device="cuda") for _ in range(3))
        rows = [3 * d, 3 * d, 3 * d, d, d]
        for name, lib in libs.items():
            t_dq = time_ms(lambda: check(lib.ltd_flash_attention_bwd_f32_dq(
                p(q), p(k), p(v), p(o), p(gr), p(lse), p(delta), p(dq), b, n, heads, *rows,
                stream)), 5)
            t_dkv = time_ms(lambda: check(lib.ltd_flash_attention_bwd_f32_dkv(
                p(q), p(k), p(v), p(gr), p(lse), p(delta), p(dk), p(dv), b, n, heads,
                *rows[:3], rows[4], stream)), 5)
            print(f"[time] flash_attention_bwd_f32 B={b} N={n} {name}: dq {t_dq:.4f} ms, "
                  f"dk/dv {t_dkv:.4f} ms", flush=True)
        del q, k, v, gr, o, lse, delta, dq, dk, dv
    b, n = 128, 256
    qkv = torch.randn(b * n, 3 * d, generator=g).cuda()
    dout = torch.randn(b * n, d, generator=g).cuda() * 0.01
    stats = torch.empty(2 * b * heads * n, device="cuda")
    dqkv = torch.empty_like(qkv)
    for name, lib in libs.items():
        args_ = (p(qkv), p(dout), p(stats), p(dqkv), b, n, heads, stream)
        t_dq = time_ms(lambda: check(lib.ltd_self_attention_bwd_f32_dq(*args_)), 20)
        t_dkv = time_ms(lambda: check(lib.ltd_self_attention_bwd_f32_dkv(*args_)), 20)
        print(f"[time] self_attention_bwd_f32 B={b} N={n} {name}: dq {t_dq:.4f} ms, "
              f"dk/dv {t_dkv:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
