"""`ln_gemm`'s W-as-stored mode on the CPU: `w_transposed=True` reads W
given as (K, N), the backward's dX = dY W with W (N, K) as stored, where
the port used to copy W^T each call. The plain version must compute the
same function as the copy route, and the wrapper on CPU tensors must take
the plain version with the flag."""

import pytest
import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_mlp_vjp as fm
from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

MODES = ["plain", "ln", "ln_xn", "bias", "f32", "residual"]


def _inputs(mode, m=37, k=96, n=256, seed=0):
    gen = torch.Generator().manual_seed(seed)
    ln = mode.startswith("ln")
    a = torch.randn(m, k, generator=gen)
    a = a if ln else a.to(torch.bfloat16)
    w = (torch.randn(n, k, generator=gen) * k ** -0.5).to(torch.bfloat16)
    kw = {}
    if ln:
        kw["ln"] = (1 + 0.1 * torch.randn(k, generator=gen), 0.1 * torch.randn(k, generator=gen))
    if mode == "ln_xn":
        kw["return_xn"] = True
    if mode == "bias":
        kw["bias"] = torch.randn(n, generator=gen)
    if mode == "f32":
        kw["out_dtype"] = torch.float32
    if mode == "residual":
        kw["residual"] = torch.randn(m, n, generator=gen)
    return a, w, kw


@pytest.mark.parametrize("mode", MODES)
def test_plain_w_transposed_equals_the_copy_route(mode):
    """ln_gemm_plain(a, W^T as stored (K, N), w_transposed=True) against
    ln_gemm_plain(a, the contiguous (N, K) copy): the same float32 products
    of the same bf16 values (1e-6 covers the two layouts' summation
    order); the normalised rows bit-equal."""
    a, w, kw = _inputs(mode)
    want = fs.ln_gemm_plain(a, w, **kw)
    got = fs.ln_gemm_plain(a, w.T.contiguous(), w_transposed=True, **kw)
    for u, v in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert u.dtype == v.dtype and u.shape == v.shape
        torch.testing.assert_close(u.float(), v.float(), atol=1e-6, rtol=1e-6)
    if mode == "ln_xn":
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("mode", MODES)
def test_wrapper_takes_w_transposed_on_cpu(mode):
    """On CPU tensors the wrapper is its plain version, flag included, and
    counts no launch."""
    fs.reset_launch_counts()
    a, w, kw = _inputs(mode, seed=1)
    wt = w.T.contiguous()
    got = fs.ln_gemm(a, wt, w_transposed=True, **kw)
    want = fs.ln_gemm_plain(a, wt, w_transposed=True, **kw)
    for u, v in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(u, v)
    assert fs.LAUNCHES["ln_gemm"] == 0


def test_dx_products_read_w_as_stored(monkeypatch):
    """The dX products of K2 (`_dx_of`, K6 through it) and of K5's backward
    take the weight as stored, no transposed copy made: `ln_gemm` with
    w_transposed=True for K2's and for K5's dx = dh W1, and K5's band
    kernel (da = g W2 inside it) W2 (D, hidden) as it is."""
    seen = []
    real = fs.ln_gemm

    def spy(a, w, *args, **kw):
        seen.append((w, kw.get("w_transposed", False)))
        return real(a, w, *args, **kw)

    monkeypatch.setattr(fs, "ln_gemm", spy)
    gen = torch.Generator().manual_seed(2)
    w = torch.randn(256, 128, generator=gen).to(torch.bfloat16)
    dy = torch.randn(16, 256, generator=gen).to(torch.bfloat16)
    dx = lv._dx_of(dy, w)
    assert seen[-1][0] is w and seen[-1][1]
    torch.testing.assert_close(dx, dy.float() @ w.float(), atol=1e-5, rtol=1e-5)

    hw, d, hidden = 4, 128, 256
    x = torch.randn(2, hw * hw, d, generator=gen).to(torch.bfloat16)
    g = torch.randn(2, hw * hw, d, generator=gen).to(torch.bfloat16)
    w1 = (torch.randn(hidden, d, generator=gen) * d ** -0.5).to(torch.bfloat16)
    w2 = (torch.randn(d, hidden, generator=gen) * hidden ** -0.5).to(torch.bfloat16)
    b1 = torch.randn(hidden, generator=gen)
    dw = torch.randn(9, hidden, generator=gen).to(torch.bfloat16)
    dwb = torch.randn(hidden, generator=gen)
    seen.clear()
    handed = []

    def band(*args):  # the band kernel's w2, as _mlp_bwd hands it over
        handed.append(args[6])
        return fm._KERNEL_BWD_OPS[0](*args)

    ops = (band,) + fm._KERNEL_BWD_OPS[1:3] + (fs.ln_gemm,)
    fm._mlp_bwd(x, g, w1, b1, dw, dwb, w2, hw, ops)
    transposed = [w_ for w_, flag in seen if flag]
    assert len(handed) == 1 and handed[0] is w2
    assert len(transposed) == 1 and transposed[0] is w1
