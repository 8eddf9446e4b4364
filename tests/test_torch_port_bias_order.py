"""The residual epilogue's bias order: `ln_gemm` adds acc + bias into the
float32 residual (one TMA reduce-add on the card), x + (acc + bias), the
TPU kernel's order, where the port used to add (x + acc) + bias. This
holds the port's K2 layer forward (the kernel path, on the CPU through the
plain versions) against the JAX kernel in interpret mode, once with each
order: the TPU order must be as close to the JAX kernel as the old one, to
within 1% of the rel-L2 (the two differ by the float32 rounding of one add
per element). `python tests/test_torch_port_bias_order.py` prints both."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import test_torch_port_layer_vjp as tl  # noqa: E402

from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv  # noqa: E402
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs  # noqa: E402

_TPU_ORDER = fs.ln_gemm_plain


def _old_order(a, w, bias=None, ln=None, residual=None, out_dtype=None, return_xn=False,
               w_transposed=False):
    """ln_gemm_plain with the order the port had: (x + acc) + bias."""
    if residual is None or bias is None:
        return _TPU_ORDER(a, w, bias, ln, residual, out_dtype, return_xn, w_transposed)
    out = _TPU_ORDER(a, w, None, ln, residual, out_dtype, return_xn, w_transposed)
    if return_xn:
        return out[0] + bias.reshape(-1), out[1]
    return out + bias.reshape(-1)


def _rel_l2_to_jax(bf16: bool) -> float:
    jargs = tl._cast(tl._jax_args(2 if bf16 else 0), bf16)
    want = np.asarray(tl.fused_layer_vjp(*jargs, tl.H, tl.HW, True).astype(jnp.float32))
    x, cond, *params = tl._torch(jargs)
    got = lv.fused_layer(x, cond, params, tl.H, tl.HW).float().numpy()
    return tl._rel_l2(got, want)


def measure(bf16: bool):
    """(rel-L2 with the TPU order, rel-L2 with the old order)."""
    new = _rel_l2_to_jax(bf16)
    fs.ln_gemm_plain = _old_order
    try:
        old = _rel_l2_to_jax(bf16)
    finally:
        fs.ln_gemm_plain = _TPU_ORDER
    return new, old


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_tpu_bias_order_is_as_close_to_the_jax_kernel(bf16):
    new, old = measure(bf16)
    assert new <= 1.01 * old + 1e-12, (new, old)
    assert new < (1e-5 if not bf16 else 1e-2)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    for bf16 in (False, True):
        new, old = measure(bf16)
        print(f"K2 layer forward vs the JAX kernel, {'bf16' if bf16 else 'float32'}: "
              f"rel-L2 {new:.4e} with x + (acc + b), {old:.4e} with (x + acc) + b")
