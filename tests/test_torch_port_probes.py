"""The port's probe entry points (transformer_latent_diffusion_tpu_torch/
scripts/) against the JAX probe scripts they port, on the CPU: S3
(scripts/probe_attn_softmax.py, four softmax forms), S2
(scripts/probe_train_bwd_stage.py, six backward modes) and S4
(scripts/microbench_layer.py, seven forward variants).

`scripts/` is not a package, so each JAX script is loaded by file path;
its `pl.pallas_call` runs in interpret mode through a shim that sets
`interpret=True`, and its module-level sizes are shrunk (D = 128, hidden
512, N = 16 tokens on a 4 x 4 grid, 2 heads), all with `monkeypatch`, so
nothing leaks into other tests. Both sides get the same numpy inputs from
a seed; the port runs on CPU tensors, so every kernel wrapper runs its
plain version. Tolerances (rel-L2 per compared output): float32 1e-4,
bf16 1e-2, S2's bf16res 2e-2 (the port keeps the attention probabilities
float32, which the TPU variant rounds to bf16). Outputs that a JAX variant
writes only as `_consume` guards (reductions that keep its recompute alive
against dead-code elimination) are not results and are not compared.

One case per probe also runs its `main()` on the CPU at tiny sizes, and
one S1's (scripts/microbench_int8.py) at 256 rows.

    python tests/test_torch_port_probes.py

prints the measured rel-L2 of every case (the worst compared output)."""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
from transformer_latent_diffusion_tpu_torch.ops import layer_variants as lvar
from transformer_latent_diffusion_tpu_torch.scripts import microbench_int8
from transformer_latent_diffusion_tpu_torch.scripts import microbench_layer as s4
from transformer_latent_diffusion_tpu_torch.scripts import probe_attn_softmax as s3
from transformer_latent_diffusion_tpu_torch.scripts import probe_train_bwd_stage as s2

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
D, HID, HW, HEADS = 128, 512, 4, 2
N = HW * HW
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REL_L2 = {"float32": 1e-4, "bfloat16": 1e-2, "bf16res": 2e-2}
NAMES = ("x", "cond") + lv.PARAM_NAMES
# S2: what each JAX variant writes only as a `_consume` guard
S2_GUARDS = {
    "full": (), "bf16res": (),
    "recompute": NAMES[1:],
    "no_mlp": ("ln3s", "ln3b", "w1", "b1", "dw", "dwb", "w2", "b2"),
    "no_cross": ("cond", "wq", "wkv", "ln2s", "ln2b", "b2"),
    "no_self": ("wqkv", "ln1s", "ln1b", "b2"),
}


class _Interpret:
    """The Pallas module with `pallas_call` in interpret mode."""

    def __init__(self, pl):
        self._pl = pl

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        kwargs["interpret"] = True
        return self._pl.pallas_call(*args, **kwargs)


def _jax_script(name, monkeypatch, **sizes):
    """scripts/<name>.py loaded by path, its Pallas calls interpreted and
    its module-level sizes set."""
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script inserts the root
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "pl", _Interpret(mod.pl))
    for key, value in sizes.items():
        monkeypatch.setattr(mod, key, value)
    return mod


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _round(a, dtype):
    """numpy float32 values as `dtype` holds them."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(DTYPES[dtype][1]).float().numpy()


def _np(t):
    return t.detach().float().numpy()


# ------------------------------ S3 ------------------------------


def s3_error(mp, use_exp2, postdiv, dtype):
    """rel-L2 of the probe's `attn` (the port's kernel wrapper, here its
    plain version) against the JAX probe's `attn` in interpret mode, at
    (B, H, N, 64) = (1, 2, 128, 64) in two 64-query blocks."""
    jax_s3 = _jax_script("probe_attn_softmax", mp)
    rng = np.random.default_rng(30)
    q, k, v = (_round(rng.standard_normal((1, 2, 128, 64)), dtype) for _ in range(3))
    jdt, tdt = DTYPES[dtype]
    want = jax_s3.attn(*(jnp.asarray(a, jdt) for a in (q, k, v)), use_exp2, postdiv,
                       q_block=64)
    got = s3.attn(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), use_exp2, postdiv)
    assert got.dtype == tdt and got.shape == (1, 2, 128, 64)
    return _rel_l2(_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tag,use_exp2,postdiv", s3.VARIANTS)
def test_s3_softmax_form_matches_jax(monkeypatch, tag, use_exp2, postdiv, dtype):
    """Each softmax form against the JAX probe's (`s3_error`)."""
    r = s3_error(monkeypatch, use_exp2, postdiv, dtype)
    assert r < REL_L2[dtype], (tag, r)


# ------------------------------ S2 ------------------------------


def _param_std(shape):
    """(mean, std) of a parameter: products scaled by their fan-in, taps by
    1/3, LayerNorm scales about 1 (the even rows), shifts and biases 0.1."""
    if len(shape) == 1:
        return 0.0, 0.1
    if shape == (3, 3, HID):
        return 0.0, 1 / 3
    return 0.0, shape[0] ** -0.5


def _s2_inputs(dtype, seed=20):
    """x, cond, g and the JAX-layout parameters (`param_shapes`), every
    value as `dtype` holds it."""
    rng = np.random.default_rng(seed)
    acts = [_round(rng.standard_normal(s), dtype) for s in ((2, N, D), (2, 2, D), (2, N, D))]
    arrays = []
    for i, s in enumerate(s2.param_shapes(D, HID)):
        shape = (s[1],) if s[0] == 1 else (3, 3, HID) if s == (9, HID) else s
        mean, std = _param_std(shape)
        mean = 1.0 if lv.PARAM_NAMES[i] in ("ln1s", "ln2s", "ln3s") else mean
        arrays.append(_round(mean + rng.standard_normal(shape) * std, dtype))
    return acts, arrays


def _jax_to_port(name, a):
    """A JAX-layout gradient in the port's parameter layout."""
    a = np.asarray(a, np.float32)
    if name in ("wqkv", "wq", "wkv", "w1", "w2"):
        return a.T
    return a.reshape(9, HID) if name == "dw" else a.reshape(-1) if a.shape[0] == 1 else a


S2_CASES = [(m, dt) for m in lv.BWD_MODES for dt in DTYPES
            if not (m == "bf16res" and dt == "float32")]


def s2_errors(mp, mode, dtype):
    """{(function, output): rel-L2} of one backward mode through the
    kernel path (`fused_layer_bwd_variant`) and its written-out plain
    version against the JAX probe's `pallas_bwd_variant` in interpret
    mode, at batch 2: every output that is not a `_consume` guard
    (S2_GUARDS)."""
    jax_s2 = _jax_script("probe_train_bwd_stage", mp, N=N, D=D, K=HID, HEADS=HEADS, HW=HW)
    (x, cond, g), arrays = _s2_inputs(dtype)
    jdt, tdt = DTYPES[dtype]
    want = jax_s2.pallas_bwd_variant(mode, *(jnp.asarray(a, jdt) for a in (x, cond, g)),
                                     [jnp.asarray(a, jdt) for a in arrays])
    params = s2.to_port(arrays, HID, tdt)
    args = [torch.from_numpy(a).to(tdt) for a in (x, cond, g)]
    errors = {}
    for fn in (lv.fused_layer_bwd_variant, lv.fused_layer_bwd_variant_plain):
        dx, dcond, grads = fn(mode, *args, params, HEADS, HW)
        for name, u, w in zip(NAMES, [dx, dcond, *grads], want):
            if name in S2_GUARDS[mode]:
                continue
            assert u is not None, (mode, name)
            errors[fn.__name__, name] = _rel_l2(_np(u), _jax_to_port(name, w))
    return errors


@pytest.mark.parametrize("mode,dtype", S2_CASES)
def test_s2_backward_mode_matches_jax(monkeypatch, mode, dtype):
    """Each backward mode against the JAX probe's (`s2_errors`). bf16res
    is a bf16 mode only (it rounds the residuals to bf16)."""
    bound = REL_L2["bf16res" if mode == "bf16res" else dtype]
    for key, r in s2_errors(monkeypatch, mode, dtype).items():
        assert r < bound, (mode, key, r)


# ------------------------------ S4 ------------------------------


def _s4_inputs(dtype, seed=40):
    """The JAX-layout parameters (LayerNorms and biases float32, the rest
    as `dtype` holds them), x and cond."""
    rng = np.random.default_rng(seed)

    def mk(*shape, f32=False, mean=0.0):
        std = 1.0 if len(shape) == 3 and shape[0] == 2 else _param_std(shape)[1]
        a = (mean + rng.standard_normal(shape) * std).astype(np.float32)
        return a if f32 else _round(a, dtype)

    params = [mk(D, f32=True, mean=1.0), mk(D, f32=True), mk(D, 3 * D),
              mk(D, f32=True, mean=1.0), mk(D, f32=True), mk(D, D), mk(D, 2 * D),
              mk(D, f32=True, mean=1.0), mk(D, f32=True), mk(D, HID), mk(HID, f32=True),
              mk(3, 3, HID), mk(HID, f32=True), mk(HID, D), mk(D, f32=True)]
    return params, mk(2, N, D), mk(2, 2, D)


def s4_errors(mp, attn_mode, dw_mode, dtype):
    """{function: rel-L2} of one forward variant through the kernel path
    (`fused_layer_fwd_variant`) and its plain version against the JAX
    probe's `make_variant` in interpret mode, at batch 2: the layer's
    update (output - x). base x base is also checked to be the training
    forward itself."""
    jax_s4 = _jax_script("microbench_layer", mp, D=D, HID=HID, N=N, HW=HW, HEADS=HEADS)
    params, x, cond = _s4_inputs(dtype)
    jdt, tdt = DTYPES[dtype]
    jparams = [jnp.asarray(p, jnp.float32 if p.ndim == 1 else jdt) for p in params]
    want = jax_s4.make_variant(jparams, attn_mode, dw_mode, 2)(jnp.asarray(x, jdt),
                                                                 jnp.asarray(cond, jdt))
    port = [torch.from_numpy(np.ascontiguousarray(
        p.T if p.ndim == 2 else p.reshape(9, HID) if p.ndim == 3 else p))
        .to(torch.float32 if p.ndim == 1 else tdt) for p in params]
    xt, ct = (torch.from_numpy(a).to(tdt) for a in (x, cond))
    x0 = _np(xt)
    errors = {}
    for fn in (lvar.fused_layer_fwd_variant, lvar.fused_layer_fwd_variant_plain):
        got = fn(attn_mode, dw_mode, xt, ct, port, HEADS, HW)
        assert got.dtype == tdt
        errors[fn.__name__] = _rel_l2(_np(got) - x0, np.asarray(want, np.float32) - x0)
    if (attn_mode, dw_mode) == ("base", "base"):
        assert torch.equal(got, lv.fused_layer_fwd(xt, ct, port, HEADS, HW))
    return errors


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tag,attn_mode,dw_mode", s4.VARIANTS)
def test_s4_forward_variant_matches_jax(monkeypatch, tag, attn_mode, dw_mode, dtype):
    """Each forward variant against the JAX probe's (`s4_errors`)."""
    for key, r in s4_errors(monkeypatch, attn_mode, dw_mode, dtype).items():
        assert r < REL_L2[dtype], (tag, key, r)


# ------------------------------ the entry points ------------------------------


def test_s3_main_runs_on_cpu():
    out = s3.main(["--device", "cpu", "--batch", "1", "--heads", "2", "--tokens", "96",
                   "--reps", "1"])
    assert [tag for tag, *_ in s3.VARIANTS] == list(out["variants"])
    for r in out["variants"].values():
        assert torch.isfinite(r["out"].float()).all() and r["launches"] == {}


def test_s2_main_runs_on_cpu():
    out = s2.main(["--device", "cpu", "--batch", "2", "--hw", "4", "--dim", "128",
                   "--hidden", "512", "--heads", "2", "--reps", "1"])
    assert list(out["modes"]) == list(lv.BWD_MODES)
    assert out["flops"]["full"] > out["flops"]["fwd"]


def test_s2_stage_flops_are_the_jax_probes():
    """The per-image operation counts at the flagship's shapes are the JAX
    probe's analytic accounting (GFLOP: fwd 3.84, recompute 2.63, MLP
    4.86, self 2.21, cross 0.61; full, their sum, 10.31 of rounded
    parts)."""
    f = s2.stage_flops(256, 768, 3072)
    want = dict(fwd=3.84, recompute=2.63, mlp=4.86, self=2.21, cross=0.61)
    for key, gf in want.items():
        assert abs(f[key] / 1e9 - gf) < 0.01, key
    assert f["full"] == f["recompute"] + f["mlp"] + f["self"] + f["cross"]
    assert abs(f["full"] / 1e9 - 10.31) < 0.02


def test_s4_main_runs_on_cpu():
    out = s4.main(["--device", "cpu", "--batch", "2", "--hw", "4", "--dim", "128",
                   "--hidden", "512", "--heads", "2", "--iters", "1"])
    tags = [tag for tag, *_ in s4.VARIANTS]
    assert list(out["variants"]) == tags + ["bwd_base", "fwd_lib"]
    base = out["variants"]["base"]["out"]
    for tag in s4.SAME_AS_BASE:
        assert torch.equal(out["variants"][tag]["out"], base), tag


def test_s1_main_runs_on_cpu():
    out = microbench_int8.main(["--device", "cpu", "--rows", "256", "--reps", "1"])
    assert out["rel_l2"] == 0.0 and out["launches"] == {}


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    cases = ([("s3", tag, dt, lambda mp, a=(e2, pd), dt=dt: {"": s3_error(mp, *a, dt)})
              for tag, e2, pd in s3.VARIANTS for dt in DTYPES]
             + [("s2", m, dt, lambda mp, m=m, dt=dt: s2_errors(mp, m, dt))
                for m, dt in S2_CASES]
             + [("s4", tag, dt, lambda mp, a=(am, dm), dt=dt: s4_errors(mp, *a, dt))
                for tag, am, dm in s4.VARIANTS for dt in DTYPES])
    for probe, tag, dt, fn in cases:
        with pytest.MonkeyPatch.context() as mp:
            errors = fn(mp)
        key, worst = max(errors.items(), key=lambda kv: kv[1])
        print(f"{probe} {tag:18s} {dt:9s} worst rel-L2 {worst:.2e} {key}")
