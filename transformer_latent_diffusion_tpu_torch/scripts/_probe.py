"""What the probe entry points share: the device (a card, or the CPU for a
rehearsal on the plain versions), timing, errors, the card's published
peaks and the least time of a piece of work, and the port's launch counts.

On a card, times come from CUDA events around many launches after a
warm-up; on the CPU from the host clock, and they time the plain versions
(a rehearsal, not a measurement of any device).
"""

from __future__ import annotations

import time

import torch

# the card's published peaks (H100 SXM, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OP_S = 1979e12
# a kernel against its plain version on the same inputs, rel-L2 (a bf16
# output may differ by one rounding step)
KERNEL_REL_L2 = 1e-2


def get_device(name: str) -> torch.device:
    """The device to run on; "cuda" without a card raises (there is no
    fallback to the CPU: pass "cpu" to rehearse on the plain versions)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the probe measures the kernels on one; "
                           "--device cpu rehearses it on the plain versions")
    return dev


def describe(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(dev)})"
    return f"{dev.type} (plain versions, host clock)"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev: torch.device, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms of one call of `fn` over `reps` calls after `warmup`."""
    for _ in range(warmup):
        fn()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync(dev)
    return start.elapsed_time(end) / reps


def time_against_plain(kern, plain, dev, reps=20, plain_reps=None):
    """(kernel ms, plain ms), each the mean of two timings taken plain,
    kernel, kernel, plain."""
    plain_reps = plain_reps or reps
    p1 = time_ms(plain, dev, plain_reps, 1)
    k1 = time_ms(kern, dev, reps)
    k2 = time_ms(kern, dev, reps)
    p2 = time_ms(plain, dev, plain_reps, 1)
    return (k1 + k2) / 2, (p1 + p2) / 2


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def errors(out, ref):
    """(rel-L2, max-abs relative to ref's largest magnitude)."""
    out, ref = out.float(), ref.float()
    scale = float(ref.abs().max())
    return rel_l2(out, ref), float((out - ref).abs().max()) / max(scale, 1e-30)


def bound(nbytes, flops, peak):
    """(least ms, "bytes" or "operations") for moving `nbytes` and doing
    `flops` at `peak` operations per second."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_counts():
    """{kernel: launches counted so far} over every kernel of the port."""
    from transformer_latent_diffusion_tpu_torch.ops import (
        attention,
        fused_attn_vjp,
        fused_block,
        fused_layer_vjp,
        fused_mlp_vjp,
        fused_stack,
        fused_stack_int8,
        layer_variants,
    )

    counts = {}
    for mod in (attention, fused_attn_vjp, fused_block, fused_layer_vjp, fused_mlp_vjp,
                fused_stack, fused_stack_int8, layer_variants):
        counts.update(mod.LAUNCHES)
    return counts


def launches_since(before):
    """{kernel: launches} since `before` (a `launch_counts()`), the kernels
    launched only."""
    return {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
