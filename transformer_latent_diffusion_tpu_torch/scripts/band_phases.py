"""Where a block of K5's band kernels spends its time on the card.

Builds a copy of `csrc/` whose `mlp_band_fwd` and `mlp_band_bwd` kernels
have thread 0 of each block write a `%globaltimer` stamp at each phase
boundary (and its SM at the first) into a device array, runs each kernel
at the given shape after two warm-up launches, and prints for each phase
its mean and spread over the blocks, how long a block lives, how many SMs
the grid used and how many blocks were resident at once. The stamps cost
a few instructions a block; the kernels' own code is unchanged.

    python -m transformer_latent_diffusion_tpu_torch.scripts.band_phases \\
        [--batch 64] [--hw 32] [--dim 768]

Needs a card and the CUDA toolkit's nvcc; the copy and its libraries go
under `build/band_phases/` beside the kernels' own build.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from transformer_latent_diffusion_tpu_torch.ops import _build

STAMPS = 10  # a block's slots: stamps, then its SM in the last
HEAD = r'''
__device__ unsigned long long g_stamps[%(blocks)d * %(slots)d];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0) {
    const int id = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    g_stamps[id * %(slots)d + k] = t;
    if (k == 0) {
      unsigned sm;
      asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(sm));
      g_stamps[id * %(slots)d + %(slots)d - 1] = sm;
    }
  }
}
'''
TAIL = '''
extern "C" int stamps_get(void* host, size_t bytes) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, bytes));
}
'''
# (text to find, the text with a stamp): each phase boundary of each kernel
EDITS = {
    "mlp_band_fwd.cu": (
        ("products", "stage + cluster barrier", "walk"),
        [("  __syncthreads();\n", "  __syncthreads();\n  stamp(0);\n"),
         ("    named_barrier(1, THREADS);  // both warpgroups",
          "    stamp(1);\n    named_barrier(1, THREADS);  // both warpgroups"),
         ("  cluster.sync();  // every tile of the cluster is staged\n",
          "  cluster.sync();  // every tile of the cluster is staged\n  stamp(2);\n"),
         ("  cluster.sync();  // the neighbours are done",
          "  stamp(3);\n  cluster.sync();  // the neighbours are done")]),
    "mlp_band_bwd.cu": (
        ("product h + stage h", "product da", "stage da", "cluster barrier 1 + walk 1",
         "cluster barrier 2 + walk 2 + the warps' sums", "cluster barrier 3 + rank 0's sums"),
        [("  setmaxnreg_inc<CONSUMER_REGS>();\n", "  setmaxnreg_inc<CONSUMER_REGS>();\n  stamp(0);\n"),
         ("    ring.product<true>(acc, wg, wt, tid);  // da = g W2c\n",
          "    stamp(1);\n    ring.product<true>(acc, wg, wt, tid);  // da = g W2c\n    stamp(2);\n"),
         ("  cluster.sync();  // 1: every", "  stamp(3);\n  cluster.sync();  // 1: every"),
         ("  cluster.sync();  // 2: every", "  stamp(4);\n  cluster.sync();  // 2: every"),
         ("  cluster.sync();  // 3: every", "  stamp(5);\n  cluster.sync();  // 3: every"),
         ("  cluster.sync();  // 4: the", "  stamp(6);\n  cluster.sync();  // 4: the")]),
}


def traced_sources(blocks: int) -> Dict[str, str]:
    """The two kernels' sources with the stamps (pure: raises if a kernel
    no longer has a boundary the edits expect)."""
    out = {}
    for name, (_, edits) in EDITS.items():
        src = (_build.CSRC / name).read_text()
        src = src.replace("namespace {\n", "namespace {\n" + HEAD % {
            "blocks": blocks, "slots": STAMPS}, 1)
        for old, new in edits:
            if old not in src:
                raise ValueError(f"{name}: no {old.strip()!r} to stamp")
            src = src.replace(old, new, 1)
        out[name] = src + TAIL
    return out


def build(blocks: int) -> Dict[str, ctypes.CDLL]:
    root = _build.BUILD_ROOT.parent / "band_phases"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = {}
    for name, src in traced_sources(blocks).items():
        (root / name).write_text(src)
        lib = root / f"{Path(name).stem}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *flags, "-shared", "-o", str(lib), str(root / name),
             *_build.LINK_FLAGS], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the stamped {name}:\n{log}")
        entry = "ltd_" + Path(name).stem
        handle = ctypes.CDLL(str(lib))
        getattr(handle, entry).argtypes = _build.SIGNATURES[entry]
        getattr(handle, entry).restype = ctypes.c_int
        handle.stamps_get.argtypes = (ctypes.c_void_p, ctypes.c_size_t)
        libs[name] = handle
    return libs


def report(tag: str, stamps: np.ndarray, phases: List[str]) -> None:
    t = stamps[:, :len(phases) + 1].astype(np.int64)
    start, end = t[:, 0] - t[:, 0].min(), t[:, -1] - t[:, 0].min()
    span = end.max()
    print(f"[{tag}] {len(t)} blocks over {span / 1e3:.1f} us (starts: median "
          f"{np.median(start) / 1e3:.1f} us, last {start.max() / 1e3:.1f} us)")
    for k, name in enumerate(phases):
        d = (t[:, k + 1] - t[:, k]) / 1e3
        print(f"[{tag}]   {name}: mean {d.mean():.2f} us (p10 {np.percentile(d, 10):.2f}, "
              f"p90 {np.percentile(d, 90):.2f})")
    sms = stamps[:, -1].astype(np.int64)
    resident = [int(np.sum((start <= s) & (end > s))) for s in np.linspace(0, span, 200)]
    print(f"[{tag}]   a block lives {(end - start).mean() / 1e3:.2f} us on average; "
          f"SMs used {len(np.unique(sms))}; blocks resident at once: mean "
          f"{np.mean(resident):.0f}, p10 {np.percentile(resident, 10):.0f}, max "
          f"{max(resident)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--hw", type=int, default=32)
    ap.add_argument("--dim", type=int, default=768)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the stamps are taken on one")
    b, hw, d, c = args.batch, args.hw, args.dim, 4 * args.dim
    tiles = -(-hw * hw // 128)
    blocks = tiles * (c // 128) * b
    _build.load_library()
    libs = build(blocks)
    print(f"{torch.cuda.get_device_name(0)}; batch {b}, hw {hw}, D {d}, hidden {c}: {blocks} "
          f"blocks a launch", flush=True)
    g = torch.Generator().manual_seed(0)

    def r(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * std).to("cuda", dtype)

    bf = torch.bfloat16
    x, gr = r(b * hw * hw, d, dtype=bf), r(b * hw * hw, d, dtype=bf)
    w1, w2 = r(c, d, std=d ** -0.5, dtype=bf), r(d, c, std=c ** -0.5, dtype=bf)
    b1, dwb, dw = r(c, std=0.1), r(c, std=0.1), r(9, c, std=1 / 3, dtype=bf)
    a, dh = (torch.empty(b * hw * hw, c, dtype=bf, device="cuda") for _ in range(2))
    sums = torch.empty((1 + b) * 11, c, device="cuda")
    counters = torch.zeros(c // 128, dtype=torch.int32, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def p(t):
        return ctypes.c_void_p(t.data_ptr())

    calls = {
        "mlp_band_fwd.cu": lambda lib: lib.ltd_mlp_band_fwd(
            p(x), p(w1), p(b1), p(dw), p(dwb), p(a), b, hw, d, c, stream),
        "mlp_band_bwd.cu": lambda lib: lib.ltd_mlp_band_bwd(
            p(x), p(gr), p(w1), p(b1), p(dw), p(dwb), p(w2), p(a), p(dh), p(sums[11:]),
            p(sums[:11]), p(counters), b, hw, d, c, stream)}
    host = np.zeros((blocks, STAMPS), dtype=np.uint64)
    for name, lib in libs.items():
        for _ in range(3):  # the last launch's stamps are read
            err = calls[name](lib)
            if err:
                raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")
        torch.cuda.synchronize()
        if lib.stamps_get(host.ctypes.data, host.nbytes):
            raise RuntimeError(f"{name}: reading the stamps failed")
        report(Path(name).stem, host, list(EDITS[name][0]))
    return host


if __name__ == "__main__":
    main()
