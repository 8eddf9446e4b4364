"""Build the hand-written CUDA kernels (`csrc/*.cu`) at first use.

`nvcc` compiles every source in `csrc/` for Hopper (`sm_90a`), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, linked against the CUDA driver
library (`-lcuda`, for the TMA kernels' tensor maps), which is loaded with
`ctypes`.
The library goes to `build/kernels/<hash>/` at the repository root (listed
in `.gitignore`), keyed by a hash of the sources and the compiler flags,
so an edit to a kernel rebuilds it and an unchanged tree reuses the last
build. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the link step: the driver library gives cuTensorMapEncodeTiled, with
# which the TMA kernels encode their tensor maps
LINK_FLAGS = ("-lcuda",)
LIB_NAME = "libltd_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: each returns the cudaError_t of its launch
SIGNATURES = {
    "ltd_ln_gemm": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "ltd_ln_gemm_scratch_rows": (_I, _I, _I, _I),
    "ltd_self_attention": (_P, _P, _I, _I, _I, _I, _P),
    "ltd_cross_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "ltd_dwconv_gelu": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "ltd_ln_gemm_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "ltd_self_attention_f32": (_P, _P, _I, _I, _I, _I, _P),
    "ltd_cross_attention_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ltd_weight_grad": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ltd_colsum": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ltd_layernorm_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "ltd_dwconv_gelu_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "ltd_weight_grad_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ltd_self_attention_bwd_f32_dq": (_P, _P, _P, _P, _I, _I, _I, _P),
    "ltd_self_attention_bwd_f32_dkv": (_P, _P, _P, _P, _I, _I, _I, _P),
    "ltd_cross_attention_bwd_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ltd_self_attention_bwd": (_P, _P, _P, _I, _I, _I, _I, _P),
    "ltd_cross_attention_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ltd_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "ltd_flash_attention_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "ltd_flash_attention_variant": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _P),
    "ltd_head_group_attention": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    "ltd_flash_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "ltd_flash_attention_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _P),
    "ltd_flash_attention_bwd_f32_dq": (_P, _P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "ltd_flash_attention_bwd_f32_dkv": (_P, _P, _P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _I, _I, _P),
    "ltd_rowquant": (_P, _P, _P, _P, _P, _I, _I, _P),
    "ltd_gemm_i8": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ltd_ln_gemm_i8": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ltd_dwconv_gelu_q8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "ltd_mlp_band_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ltd_mlp_band_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _P),
    # the bf16 attention pair's route (csrc/attn_pair.cu, self_attention.cu)
    "ltd_self_attention_x1": (_P, _P, _P, _I, _I, _I, _I, _P),
    "ltd_pair_scratch_rows": (_I, _I, _I, _I),
    "ltd_pair_qkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "ltd_pair_cross_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "ltd_pair_cross_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _P),
    "ltd_pair_ln_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the kernels unless this exact source set is built already.
    The compilers' logs (with ptxas register and shared-memory counts) are
    kept beside the library as `build.log`."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.parent / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], False
    for cmd, _, proc in jobs:
        text, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{text}")
        failed |= proc.returncode != 0
    if not failed:
        tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs),
               *LINK_FLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        failed = proc.returncode != 0
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    text = "".join(log) + f"\nseconds: {time.perf_counter() - t0:.1f}\n"
    (out.parent / "build.log").write_text(text)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{text}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use and loaded once."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
