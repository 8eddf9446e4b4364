"""How fast Hopper's tensor cores run the float32 bodies' TF32 products,
and how they read a TF32 operand.

Builds a small CUDA source of its own (under `build/tf32_wgmma_rate/`,
with `csrc/hopper.cuh`) whose kernels issue 20,000 K steps of three
`wgmma` m64n64k8 or m64n128k8 TF32 products with A from registers and B
from shared memory (the 3xTF32 form of the float32 bodies) on every SM,
with one or two warpgroups a block, waiting for the previous step before
the next (`wait<1>`, as the kernels do) or not at all, with the A
fragments constant or read from shared memory and split as the kernels
split them (`tf32_split`'s round-to-nearest conversions: hi, lo) at every
step; prints each form's TFLOP/s of TF32 work against the card's 495.
Then one product of 8 x (1 + 2^-11 + 2^-13) by 1: 8.0 if the tensor cores
ignore a TF32 operand's low 13 bits, 8.0078125 if they round it; and one
product adding 0.75 of float32's ulp at 1 into an accumulator holding 1:
1 + 2^-23 if the accumulator rounds to nearest, 1 if it truncates.

    python -m transformer_latent_diffusion_tpu_torch.scripts.tf32_wgmma_rate

Needs a card and the CUDA toolkit's nvcc (~20 s of command).
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from transformer_latent_diffusion_tpu_torch.ops import _build

OUT = _build.BUILD_ROOT.parent / "tf32_wgmma_rate"
STEPS = 20000
# (name, N, warpgroups a block, split A at every step) in the order of
# SOURCE's `run` cases
FORMS = (("n64 1wg wait1", 64, 1, False), ("n64 2wg wait1", 64, 2, False),
         ("n64 1wg nowait", 64, 1, False), ("n64 2wg nowait", 64, 2, False),
         ("n64 1wg wait1 split", 64, 1, True), ("n64 2wg wait1 split", 64, 2, True),
         ("n64 2wg wait0 split", 64, 2, True), ("n128 1wg wait1", 128, 1, False),
         ("n128 2wg wait1", 128, 2, False), ("n128 2wg wait1 split", 128, 2, True))
SOURCE = r'''#include "hopper.cuh"

template <int N, int NWG, int WAIT, bool SPLIT>
__global__ void __launch_bounds__(384, 1) mb(float* out, int steps) {
  extern __shared__ unsigned char smraw[];
  unsigned char* sm = align1024(smraw);
  for (int i = threadIdx.x; i < 65536 / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0, 0, 0, 0);
  float* raw = reinterpret_cast<float*>(sm + 65536);
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) raw[i] = 1.0f + i * 1e-3f;
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x >= NWG * 128) return;
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  uint32_t fh[2][4], fl[2][4];
  const int t = threadIdx.x & 127;
  for (int i = 0; i < steps; ++i) {
    const int b = i & 1;
    if (SPLIT) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = raw[(t * 4 + e + i * 7) & 4095];
      tf32_frag(x, fh[b], fl[b]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) { fh[b][e] = 0x3f800000u; fl[b][e] = 0x3f800000u + i; }
    }
    wgmma_fence();
    const uint64_t dh = sw128_desc(sm + (i & 3) * 32, 16, 1024), dl = sw128_desc(sm + 16384 + (i & 3) * 32, 16, 1024);
    if constexpr (N == 64) {
      wgmma_m64n64k8_tf32_rs(d, fl[b], dh, 1);
      wgmma_m64n64k8_tf32_rs(d, fh[b], dl, 1);
      wgmma_m64n64k8_tf32_rs(d, fh[b], dh, 1);
    } else {
      wgmma_m64n128k8_tf32_rs(d, fl[b], dh, 1);
      wgmma_m64n128k8_tf32_rs(d, fh[b], dl, 1);
      wgmma_m64n128k8_tf32_rs(d, fh[b], dh, 1);
    }
    wgmma_commit();
    if (WAIT == 1) wgmma_wait<1>();
    if (WAIT == 0) wgmma_wait<0>();
  }
  wgmma_wait<0>();
  fence_regs(d);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += d[i];
  out[blockIdx.x * 384 + threadIdx.x] = s;
}

__global__ void trunc_test(float* out) {
  __shared__ __align__(1024) float b[64 * 8 * 4];
  for (int i = threadIdx.x; i < 64 * 8 * 4; i += blockDim.x) b[i] = 1.0f;
  fence_proxy_async();
  __syncthreads();
  float d[32];
  uint32_t a[4];
  for (int e = 0; e < 4; ++e) a[e] = 0x3F801400u;  // 1 + 2^-11 + 2^-13
  wgmma_fence();
  wgmma_m64n64k8_tf32_rs_first(d, a, sw128_desc(b, 16, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  if (threadIdx.x == 0) out[0] = d[0];
}

// d = 1 + sum_k a b with a b = 1.5 2^-27 (8 terms: 0.75 of float32's ulp at
// 1, exact as a sum): 1 + 2^-23 if the accumulator adds rounding to
// nearest, 1 if it truncates
__global__ void acc_test(float* out) {
  __shared__ __align__(1024) float b[64 * 8 * 4];
  for (int i = threadIdx.x; i < 64 * 8 * 4; i += blockDim.x) b[i] = 1.0f;
  fence_proxy_async();
  __syncthreads();
  float d[32];
  for (int e = 0; e < 32; ++e) d[e] = 1.0f;
  uint32_t a[4];
  for (int e = 0; e < 4; ++e) a[e] = 0x32400000u;  // 1.5 2^-27
  wgmma_fence();
  wgmma_m64n64k8_tf32_rs(d, a, sw128_desc(b, 16, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  if (threadIdx.x == 0) out[1] = d[0];
}

extern "C" int tf32_trunc_probe(float* out) {
  trunc_test<<<1, 128>>>(out);
  acc_test<<<1, 128>>>(out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int run(int which, float* out, int steps, void* stream) {
  const int smem = 65536 + 16384 + 1024;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define L(K, ...) if (which == K) { cudaFuncSetAttribute(mb<__VA_ARGS__>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem); mb<__VA_ARGS__><<<132, 384, smem, st>>>(out, steps); }
  L(0, 64, 1, 1, false) L(1, 64, 2, 1, false) L(2, 64, 1, 2, false) L(3, 64, 2, 2, false)
  L(4, 64, 1, 1, true) L(5, 64, 2, 1, true) L(6, 64, 2, 0, true)
  L(7, 128, 1, 1, false) L(8, 128, 2, 1, false) L(9, 128, 2, 1, true)
  return static_cast<int>(cudaGetLastError());
}
'''


def main(argv=None):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "tf32_rate.cu").write_text(SOURCE)
    lib_path = OUT / "tf32_rate.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                           "-o", str(lib_path), str(OUT / "tf32_rate.cu"), *_build.LINK_FLAGS],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.tf32_trunc_probe.argtypes = [ctypes.c_void_p]
    out = torch.zeros(132 * 384, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for which, (name, n, wgs, _) in enumerate(FORMS):
        assert lib.run(which, ctypes.c_void_p(out.data_ptr()), 100, stream) == 0
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        assert lib.run(which, ctypes.c_void_p(out.data_ptr()), STEPS, stream) == 0
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        flop = 2 * 132 * wgs * STEPS * 3 * 64 * n * 8
        print(f"[rate] {name}: {ms:.3f} ms, {flop / ms / 1e9:.1f} TFLOP/s of TF32 "
              f"({flop / ms / 1e9 / 495:.1%} of 495)", flush=True)
    probe = torch.zeros(4, device="cuda")
    assert lib.tf32_trunc_probe(ctypes.c_void_p(probe.data_ptr())) == 0
    torch.cuda.synchronize()
    print(f"[read] 8 x (1 + 2^-11 + 2^-13) through a TF32 wgmma = {probe[0].item()!r} "
          f"(8.0: the low 13 bits ignored; 8.0078125: rounded)", flush=True)
    print(f"[add] 1 + 8 x 1.5 2^-27 into a float32 accumulator = {probe[1].item()!r} "
          f"(1.0000001192092896: rounded to nearest; 1.0: truncated)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
