"""The hi-res sep-conv MLP, differentiable: TPU kernel K5's forward and
backward, each a hand-written band kernel and the kernels around it, and
their plain PyTorch versions.

Counterpart of the JAX package's `ops/fused_mlp_vjp.py`:
`fused_mlp_sepconv_vjp` (`_pallas_fwd`, :182-205, kernel `_fwd_kernel`,
:119-129) computes

    y = GELU(dw3x3(x W1 + b1) + dwb) W2 + b2

per image with the float32 hidden state h and the convolution's output c
in VMEM, the GELU output a rounded to the weights' dtype before the
contract product, y in x's dtype; its backward (`_pallas_bwd`, :208-246,
kernel `_bwd_kernel`, :135-179) recomputes h, c and a and returns dx, dW1,
db1, the 9 tap gradients, ddwb, dW2 and db2, with g, da's product operand
and dh rounded to the weights' dtype before their products. The linen path
runs it for a square grid of at most `FUSED_MLP_MAX_TOKENS` tokens
(models/blocks.py:184-210): at 512 px in serving, and in training on every
square grid of 256 < N <= 1024 tokens.

A Hopper SM cannot hold one image's float32 hidden state (1024 x 3072 x 4
bytes = 12.6 MB). The band kernels (csrc/mlp_band_fwd.cu,
csrc/mlp_band_bwd.cu; csrc/mlp_band.cuh) keep it on chip all the same: a
block owns 128 tokens x 128 hidden channels of one image, the blocks of an
image's tiles form a thread-block cluster, and the 3x3 taps read the
neighbouring tiles through distributed shared memory (`BandPlan`). Both
directions run in the weights' dtype, bf16 or float32 (the JAX package's
default compute dtype, whose TPU kernel rounds nothing); the float32
routes compose the float32 bodies of the other kernels:

  forward   bf16 x and weights          float32 x and weights
            mlp_band_fwd                ln_gemm_f32 (3xTF32)
              h = x W1 + b1 and           h = x W1 + b1, float32
              c = dw3x3(h) + dwb        dwconv_gelu_f32
              on chip, float32;           a = GELU(c), float32, row-band
              a = bf16(GELU(c)) out       body at hw = 32
            ln_gemm                     ln_gemm_f32
              y = a W2 + b2 in x's        y = a W2 + b2, float32
              dtype
            (no residual: the block adds it outside, as the linen path does)
  backward  mlp_band_bwd                ln_gemm_f32
              h = x W1 + b1 and           h = x W1 + b1
              da = g W2 (recomputed,    dwconv_gelu_f32, return_c
              float32), c, dc =           a = GELU(c) and c, row band
              da GELU'(c) on chip;      ln_gemm_f32, w_transposed
              a and dh (bf16) out,        da = g W2
              the 9 tap sums, ddwb      dwconv_gelu_bwd_f32, row bands
              and db1 (float32)           dh, the 9 tap sums, ddwb, db1
            weight_grad                 weight_grad_f32
              dW2 = g^T a                 dW2 = g^T a
            colsum                      colsum
              db2 = the column sums       db2 = the column sums of g
              of g (bf16, read as it is)
            weight_grad                 weight_grad_f32
              dW1 = dh^T x                dW1 = dh^T x
            ln_gemm                     ln_gemm_f32, w_transposed
              dx = dh W1 in x's dtype     dx = dh W1

`ROUTE_LAUNCHES` has these launches. On the bf16 route device memory sees
x, g, a and dh, never h, c, da or dc; the float32 route (the TPU kernel
rounds nothing in float32, and neither does it) composes the float32
bodies of K1 and K2, with h, c, a, da and dh through device memory. The
GELU is the exact erf, where the TPU kernel uses a polynomial
(`_erf_poly`, within ~1e-7).

Weights are in the port's (out, in) layout: w1 (hidden, D), w2 (D,
hidden), dw (9, hidden) with tap di*3+dj; b1, dwb, b2 float32. The
gradients come back in the same layouts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

KERNELS = ("mlp_band_fwd", "mlp_band_bwd", "fused_mlp_sepconv", "fused_mlp_sepconv_f32",
           "fused_mlp_sepconv_bwd", "fused_mlp_sepconv_bwd_f32")
# since the last reset_launch_counts(): the launches of the band kernels
# ("mlp_band_fwd", "mlp_band_bwd"), and the calls of the four routes
# ("fused_mlp_sepconv", "fused_mlp_sepconv_f32", "fused_mlp_sepconv_bwd",
# "fused_mlp_sepconv_bwd_f32"), whose other launches count under their
# kernels' names (ROUTE_LAUNCHES)
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# the kernel launches of one call of each route on CUDA; ln_gemm and
# dwconv_gelu count in fused_stack.LAUNCHES, their float32 bodies in
# fused_stack_f32.LAUNCHES, weight_grad and colsum in
# fused_layer_vjp.LAUNCHES, weight_grad_f32 and dwconv_gelu_bwd_f32 in
# fused_layer_vjp_f32.LAUNCHES
ROUTE_LAUNCHES = {
    "fused_mlp_sepconv": {"mlp_band_fwd": 1, "ln_gemm": 1},
    "fused_mlp_sepconv_f32": {"ln_gemm_f32": 2, "dwconv_gelu_f32": 1},
    "fused_mlp_sepconv_bwd": {"mlp_band_bwd": 1, "weight_grad": 2, "colsum": 1,
                              "ln_gemm": 1},
    "fused_mlp_sepconv_bwd_f32": {"ln_gemm_f32": 3, "dwconv_gelu_f32": 1,
                                  "dwconv_gelu_bwd_f32": 1, "weight_grad_f32": 2,
                                  "colsum": 1},
}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# ------------------------------ the band kernels' plan ------------------------------

# tokens and hidden channels of a band kernel's block, the most blocks of a
# cluster (the portable size: hw <= 32), the walk's warps and the pixels
# of a run, and the backward's sums (9 taps, ddwb, db1) (csrc/mlp_band.cuh)
BAND_TILE = 128
BAND_CHUNK = 128
BAND_MAX_TILES = 8
BAND_WARPS = 8
BAND_RUN = 8
BAND_NSUM = 11


@dataclass(frozen=True)
class BandPlan:
    """How the band kernels cover `images` hw x hw grids of `channels`
    hidden channels, as csrc/mlp_band.cuh tiles them (pure: no device).

    A block owns tokens `tokens(rank)` (128 consecutive tokens of the
    row-major grid) and channels [128 chunk, ...) of an image; the `tiles`
    ranks of one image and chunk are one cluster. A tap reaches at most hw
    + 1 <= 33 tokens, so a tile's halo lies in ranks rank - 1 and rank + 1.
    The walk cuts a tile into runs of at most BAND_RUN pixels of one grid
    row (`runs`), item k to warp k % BAND_WARPS. The backward's sums: each
    thread over its runs' pixels in order, the warps in warp order, the
    cluster's ranks in rank order (an image's workspace row), then the
    images in order."""
    images: int
    hw: int
    channels: int

    @property
    def tiles(self) -> int:
        return -(-self.hw * self.hw // BAND_TILE)

    @property
    def chunks(self) -> int:
        return self.channels // BAND_CHUNK

    def tokens(self, rank: int) -> range:
        return range(rank * BAND_TILE, min((rank + 1) * BAND_TILE, self.hw * self.hw))

    def runs(self, rank: int) -> List[Tuple[int, int, int, int]]:
        """The non-empty items of tile `rank`: (item, row, first column,
        end column)."""
        t = self.tokens(rank)
        hw = self.hw
        row0, segs = t.start // hw, -(-hw // BAND_RUN)
        out = []
        for item in range(((t.stop - 1) // hw - row0 + 1) * segs):
            i = row0 + item // segs
            ja, jb = max(t.start - i * hw, 0), min(t.stop - i * hw, hw)
            j0 = ja + item % segs * BAND_RUN
            if j0 < min(j0 + BAND_RUN, jb):
                out.append((item, i, j0, min(j0 + BAND_RUN, jb)))
        return out


def band_plan(images: int, hw: int, channels: int) -> BandPlan:
    """The band kernels' plan (pure); raises ValueError on a grid or a width
    they do not take (hw > 32: more than 8 tiles a cluster)."""
    plan = BandPlan(images, hw, channels)
    if images < 1 or hw < 1 or plan.tiles > BAND_MAX_TILES:
        raise ValueError(f"mlp_band: needs 1 <= hw <= 32 (at most {BAND_MAX_TILES} tiles of "
                         f"{BAND_TILE} tokens), got {images} x {hw} x {hw}")
    if channels < BAND_CHUNK or channels % BAND_CHUNK:
        raise ValueError(f"mlp_band: needs hidden % {BAND_CHUNK} == 0, got {channels}")
    return plan


# ------------------------------ plain versions ------------------------------


def mlp_band_fwd_plain(x, w1, b1, dw, dwb, hw: int):
    """a = GELU(dw3x3(x W1^T + b1) + dwb) on the hw x hw grids of x (B*hw*hw,
    D): x rounded to w1's dtype, float32 h and c, the exact GELU rounded to
    dw's dtype."""
    h = fs.ln_gemm_plain(x, w1, bias=b1, out_dtype=torch.float32)
    return fs.dwconv_gelu_plain(h, dw, dwb, hw)


def mlp_band_bwd_plain(x, g, w1, b1, dw, dwb, w2, hw: int):
    """(a, dh, ddw (9, C), ddwb, db1) from x and g (B*hw*hw, D): h, c and a =
    GELU(c) recomputed in float32 (a rounded to dw's dtype), da = g W2 from
    g rounded to w2's dtype, dc = da GELU'(c); dh (the flipped-tap
    correlation of dc) rounded to dw's dtype, the sums float32, db1 from
    the float32 dh."""
    h = fs.ln_gemm_plain(x, w1, bias=b1, out_dtype=torch.float32)
    a, c = fs.dwconv_gelu_plain(h, dw, dwb, hw, return_c=True)
    da = fs.ln_gemm_plain(g, w2, out_dtype=torch.float32, w_transposed=True)
    dh, ddw, ddwb, db1 = lv.dwconv_gelu_bwd_plain(da, c, h, dw, hw)
    return a, dh, ddw, ddwb, db1


def _mlp(x, w1, b1, dw, dwb, w2, b2, hw: int, ops):
    band, gemm = ops
    b, n, d = x.shape
    a = band(x.reshape(b * n, d), w1, b1, dw, dwb, hw)
    return gemm(a, w2, bias=b2, out_dtype=x.dtype).reshape(b, n, d)


def _mlp_bwd(x, g, w1, b1, dw, dwb, w2, hw: int, ops):
    band_bwd, wgrad, csum, gemm = ops
    b, n, d = x.shape
    x2, g2 = x.reshape(b * n, d), g.reshape(b * n, d)
    g_lp = g2.to(w2.dtype)  # g itself where it is of the weights' dtype
    a, dh, ddw, ddwb, db1 = band_bwd(x2, g_lp, w1, b1, dw, dwb, w2, hw)
    dw2 = wgrad(g_lp, a)
    db2 = csum(g2)
    del a
    dw1 = wgrad(dh, x2)
    dx = gemm(dh, w1, out_dtype=x.dtype, w_transposed=True)
    return dx.reshape(b, n, d), dw1, db1, ddw, ddwb, dw2, db2


_PLAIN_OPS = (mlp_band_fwd_plain, fs.ln_gemm_plain)
_PLAIN_BWD_OPS = (mlp_band_bwd_plain, lv.weight_grad_plain, lv.colsum_plain,
                  fs.ln_gemm_plain)


def fused_mlp_sepconv_plain(x, w1, b1, dw, dwb, w2, b2, hw: int):
    """GELU(dw3x3(x W1 + b1) + dwb) W2 + b2 on the hw x hw token grid of
    x (B, hw*hw, D): x rounded to the weights' dtype, float32 h and c, the
    exact GELU rounded to the weights' dtype, y in x's dtype."""
    return _mlp(x, w1, b1, dw, dwb, w2, b2, hw, _PLAIN_OPS)


def fused_mlp_sepconv_bwd_plain(x, g, w1, b1, dw, dwb, w2, hw: int):
    """The TPU kernel's `_bwd_kernel`, on the kernels' plain versions:
    (dx in x's dtype, dw1 (hidden, D), db1, ddw (9, hidden), ddwb,
    dw2 (D, hidden), db2), the parameter gradients float32. h, c and
    a = GELU(c) are recomputed in float32; dW2 = a^T g and da = g W2 from
    a and g rounded to the weights' dtype, db2 from g as given;
    dc = da GELU'(c); ddwb, the taps and dh (the flipped-tap correlation)
    float32; db1 from the float32 dh, dW1 and dx from dh rounded."""
    return _mlp_bwd(x, g, w1, b1, dw, dwb, w2, hw, _PLAIN_BWD_OPS)


def _require_cuda(name: str, x):
    fs._require(x.device.type == "cuda",
                f"{name}: the kernels run on CUDA tensors (CPU tensors take the "
                f"plain version); got {x.device}")


def _band_checks(name, x, w1, b1, dw, dwb, hw: int):
    """The shapes and dtypes that a band kernel takes; its plan."""
    m, d = x.shape
    c = w1.shape[0]
    fs._require(all(t.dtype == torch.bfloat16 for t in (x, w1, dw))
                and b1.dtype == torch.float32 and dwb.dtype == torch.float32,
                f"{name}: x, w1 and dw bf16; b1 and dwb float32")
    fs._require(w1.shape == (c, d) and dw.shape == (9, c) and b1.numel() == c
                and dwb.numel() == c and d % 64 == 0 and m % (hw * hw) == 0,
                f"{name}: needs x (B*hw*hw, D) with D % 64 == 0, w1 (C, D), dw (9, C), "
                f"b1 and dwb (C,)")
    return band_plan(m // (hw * hw), hw, c)


def mlp_band_fwd(x, w1, b1, dw, dwb, hw: int):
    """Kernel wrapper of `mlp_band_fwd_plain` (csrc/mlp_band_fwd.cu), one
    launch: on CUDA x (B*hw*hw, D) bf16 with D % 64 == 0, w1 (C, D) and dw
    (9, C) bf16, b1 and dwb float32, C % 128 == 0 and hw <= 32; on CPU
    tensors the plain version."""
    if x.device.type == "cpu":
        return mlp_band_fwd_plain(x, w1, b1, dw, dwb, hw)
    dev = fs._on_cuda("mlp_band_fwd", x, w1, b1, dw, dwb)
    plan = _band_checks("mlp_band_fwd", x, w1, b1, dw, dwb, hw)
    a = torch.empty((x.shape[0], plan.channels), dtype=torch.bfloat16, device=dev)
    lib = fs.load_library()
    LAUNCHES["mlp_band_fwd"] += 1
    fs._check_launch(lib.ltd_mlp_band_fwd(fs._ptr(x), fs._ptr(w1), fs._ptr(b1), fs._ptr(dw),
                                          fs._ptr(dwb), fs._ptr(a), plan.images, hw,
                                          x.shape[1], plan.channels, fs._stream(dev)),
                     "mlp_band_fwd")
    return a


def mlp_band_bwd(x, g, w1, b1, dw, dwb, w2, hw: int):
    """Kernel wrapper of `mlp_band_bwd_plain` (csrc/mlp_band_bwd.cu), one
    launch (the kernel adds its own partial sums): on CUDA x and g (B*hw*hw,
    D) bf16, w2 (D, C) bf16, the rest as `mlp_band_fwd`; on CPU tensors the
    plain version."""
    if x.device.type == "cpu":
        return mlp_band_bwd_plain(x, g, w1, b1, dw, dwb, w2, hw)
    dev = fs._on_cuda("mlp_band_bwd", x, g, w1, b1, dw, dwb, w2)
    plan = _band_checks("mlp_band_bwd", x, w1, b1, dw, dwb, hw)
    fs._require(g.dtype == torch.bfloat16 and g.shape == x.shape
                and w2.dtype == torch.bfloat16 and w2.shape == (x.shape[1], plan.channels),
                "mlp_band_bwd: g bf16 of x's shape, w2 (D, C) bf16")
    m, c = x.shape[0], plan.channels
    a, dh = (torch.empty((m, c), dtype=torch.bfloat16, device=dev) for _ in range(2))
    # the (11, C) sums, then the images' partial rows, in one allocation
    buf = torch.empty(((1 + plan.images) * BAND_NSUM, c), dtype=torch.float32, device=dev)
    sums, ws = buf[:BAND_NSUM], buf[BAND_NSUM:]
    counters = lv._zeroed_counters(dev, plan.chunks)
    lib = fs.load_library()
    LAUNCHES["mlp_band_bwd"] += 1
    fs._check_launch(lib.ltd_mlp_band_bwd(fs._ptr(x), fs._ptr(g), fs._ptr(w1), fs._ptr(b1),
                                          fs._ptr(dw), fs._ptr(dwb), fs._ptr(w2), fs._ptr(a),
                                          fs._ptr(dh), fs._ptr(ws), fs._ptr(sums),
                                          fs._ptr(counters), plan.images, hw, x.shape[1], c,
                                          fs._stream(dev)), "mlp_band_bwd")
    return a, dh, sums[:9], sums[9], sums[10]


def _band_f32(x, w1, b1, dw, dwb, hw: int):
    """The float32 route's expand half: `ln_gemm_f32`, then
    `dwconv_gelu_f32`'s row band (float32 weights send `fs`'s wrappers to
    their float32 bodies)."""
    return fs.dwconv_gelu(fs.ln_gemm(x, w1, bias=b1, out_dtype=torch.float32), dw, dwb, hw)


def _band_bwd_f32(x, g, w1, b1, dw, dwb, w2, hw: int):
    """The float32 route's `mlp_band_bwd`: h by `ln_gemm_f32`, a and c by
    `dwconv_gelu_f32`'s row band with return_c, da = g W2 by `ln_gemm_f32`
    with W2 read as stored, then dh, the 9 tap sums, ddwb and db1 by
    `dwconv_gelu_bwd`'s float32 mode in row bands (float32 operands send
    `fs`'s and `lv`'s wrappers to their float32 bodies)."""
    h = fs.ln_gemm(x, w1, bias=b1, out_dtype=torch.float32)
    a, c = fs.dwconv_gelu(h, dw, dwb, hw, return_c=True)
    da = fs.ln_gemm(g, w2, out_dtype=torch.float32, w_transposed=True)
    dh, ddw, ddwb, db1 = lv.dwconv_gelu_bwd(da, c, h, dw, hw)
    return a, dh, ddw, ddwb, db1


_KERNEL_OPS = (mlp_band_fwd, fs.ln_gemm)
_F32_OPS = (_band_f32, fs.ln_gemm)
_KERNEL_BWD_OPS = (mlp_band_bwd, lv.weight_grad, lv.colsum, fs.ln_gemm)
_F32_BWD_OPS = (_band_bwd_f32, lv.weight_grad, lv.colsum, fs.ln_gemm)


def _forward(x, w1, b1, dw, dwb, w2, b2, hw: int):
    if x.device.type == "cpu":
        return fused_mlp_sepconv_plain(x, w1, b1, dw, dwb, w2, b2, hw)
    _require_cuda("fused_mlp_sepconv", x)
    fs._require(x.dim() == 3 and x.shape[1] == hw * hw,
                f"fused_mlp_sepconv: x must be (B, {hw * hw}, D)")
    fs._require(x.dtype in (torch.bfloat16, torch.float32)
                and all(t.dtype == x.dtype for t in (w1, dw, w2)),
                "fused_mlp_sepconv: x, w1, dw and w2 must be all bf16 or all float32")
    f32 = x.dtype == torch.float32
    y = _mlp(x.contiguous(), w1, b1, dw, dwb, w2, b2, hw, _F32_OPS if f32 else _KERNEL_OPS)
    LAUNCHES["fused_mlp_sepconv_f32" if f32 else "fused_mlp_sepconv"] += 1
    return y


def fused_mlp_sepconv_bwd(x, g, w1, b1, dw, dwb, w2, hw: int):
    """Kernel route of `fused_mlp_sepconv_bwd_plain` (same arguments and
    results): on CUDA the launches of the module docstring
    (`ROUTE_LAUNCHES`): x, g and the weights all bf16 (five launches) or
    all float32 (nine, the float32 bodies); on CPU tensors the plain
    version."""
    if x.device.type == "cpu":
        return fused_mlp_sepconv_bwd_plain(x, g, w1, b1, dw, dwb, w2, hw)
    _require_cuda("fused_mlp_sepconv_bwd", x)
    fs._require(x.dim() == 3 and x.shape[1] == hw * hw and g.shape == x.shape,
                f"fused_mlp_sepconv_bwd: x and g must be (B, {hw * hw}, D)")
    fs._require(x.dtype in (torch.bfloat16, torch.float32)
                and all(t.dtype == x.dtype for t in (g, w1, dw, w2)),
                "fused_mlp_sepconv_bwd: x, g, w1, dw and w2 must be all bf16 or all float32")
    f32 = x.dtype == torch.float32
    out = _mlp_bwd(x.contiguous(), g.contiguous(), w1, b1, dw, dwb, w2, hw,
                   _F32_BWD_OPS if f32 else _KERNEL_BWD_OPS)
    LAUNCHES["fused_mlp_sepconv_bwd_f32" if f32 else "fused_mlp_sepconv_bwd"] += 1
    return out


class FusedMLPFunction(torch.autograd.Function):
    """The sep-conv MLP as an autograd function over the kernels (their
    plain versions on CPU tensors). The forward saves x and the weights
    only, as the TPU kernel's `_vjp_fwd` does; the backward recomputes.
    Gradients come back in each input's dtype; bf16 and float32 operands
    each take their dtype's route."""

    @staticmethod
    def forward(ctx, x, w1, b1, dw, dwb, w2, b2, hw: int):
        ctx.save_for_backward(x, w1, b1, dw, dwb, w2)
        ctx.hw, ctx.b2_dtype = hw, b2.dtype
        return _forward(x, w1, b1, dw, dwb, w2, b2, hw)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, dw, dwb, w2 = ctx.saved_tensors
        dx, dw1, db1, ddw, ddwb, dw2, db2 = fused_mlp_sepconv_bwd(
            x, g.contiguous(), w1, b1, dw, dwb, w2, ctx.hw)
        return (dx.to(x.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                ddw.to(dw.dtype), ddwb.to(dwb.dtype), dw2.to(w2.dtype),
                db2.to(ctx.b2_dtype), None)


def fused_mlp_sepconv(x, w1, b1, dw, dwb, w2, b2, hw: int):
    """Kernel route of `fused_mlp_sepconv_plain` (same arguments and
    result): on CUDA one `mlp_band_fwd` launch and one `ln_gemm` launch, x
    and the weights bf16, or the float32 bodies (`ln_gemm_f32` twice,
    `dwconv_gelu_f32` once), x and the weights float32; on CPU tensors the
    plain version.
    Differentiable (`FusedMLPFunction`) where a gradient is asked for."""
    args = (x, w1, b1, dw, dwb, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedMLPFunction.apply(*args, hw)
    return _forward(*args, hw)
