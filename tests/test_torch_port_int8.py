"""The port's W8A8 int8 engine (ops/fused_stack_int8.py, TPU kernel K7)
against the JAX package's, on the same weights (converted with
convert.denoiser_state_dict) and the same numpy inputs, at the tiny
DenoiserConfig (d=128, 2 heads, 3 layers, 8x8 grid). The JAX kernel runs
in interpret mode, as tests/test_fused_int8.py runs it; the port's
wrappers run their plain versions on the CPU. Each tolerance is stated
with what was measured on the CPU."""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from transformer_latent_diffusion_tpu.configs import DenoiserConfig
from transformer_latent_diffusion_tpu.models import Denoiser as JaxDenoiser
from transformer_latent_diffusion_tpu.models.fast_denoiser import (
    make_fused_apply as jax_make_fused_apply,
)
from transformer_latent_diffusion_tpu.ops import fused_stack_int8 as jq
from transformer_latent_diffusion_tpu.ops.fused_block import _gelu_exact, _ln_f32
from transformer_latent_diffusion_tpu.ops.fused_mlp_vjp import _dw_fwd
from transformer_latent_diffusion_tpu.utils import init_denoiser_params
from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import (
    make_fused_apply,
)
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.ops import fused_stack_int8 as q8
from transformer_latent_diffusion_tpu_torch.sampling import DiffusionTransformer
from transformer_latent_diffusion_tpu_torch.sampling import diffusion as td

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def tiny():
    """JAX params of the tiny DenoiserConfig and the same weights as the
    port's state_dict."""
    cfg = DenoiserConfig()
    params = init_denoiser_params(JaxDenoiser(**asdict(cfg)), cfg)
    sd = convert.denoiser_state_dict(jax.tree.map(np.asarray, params), cfg)
    return cfg, params, {k: torch.from_numpy(v) for k, v in sd.items()}


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _rows(seed, m=64, k=128, std=2.0):
    return (np.random.default_rng(seed).standard_normal((m, k)) * std).astype(np.float32)


def _ln_params(seed, k=128):
    rng = np.random.default_rng(seed)
    return ((1 + 0.1 * rng.standard_normal(k)).astype(np.float32),
            (0.1 * rng.standard_normal(k)).astype(np.float32))


@pytest.mark.parametrize("with_ln", [False, True], ids=["no_ln", "ln"])
def test_rowquant_plain_matches_jax(with_ln):
    """Without a LayerNorm the same float32 operations: int8 values and
    scales exactly equal. With LN1 (`_ln_f32` before `_rowquant`): the
    statistics may be summed in another order, so int8 within 1 and scales
    within 1e-6 relative (measured: int8 equal, scales within 1.8e-7)."""
    x = _rows(0)
    ln = _ln_params(1) if with_ln else None
    xj = jnp.asarray(x)
    if ln is not None:
        xj = _ln_f32(xj, jnp.asarray(ln[0]), jnp.asarray(ln[1]))
    want_q, want_s = (np.asarray(t) for t in jq._rowquant(xj))
    got_q, got_s = q8.rowquant_plain(
        torch.from_numpy(x), None if ln is None else tuple(map(torch.from_numpy, ln)))
    assert got_q.dtype == torch.int8 and got_q.shape == x.shape
    assert got_s.dtype == torch.float32 and got_s.shape == (x.shape[0], 1)
    diff = np.abs(got_q.numpy().astype(int) - want_q.astype(int))
    if ln is None:
        assert diff.max() == 0
        np.testing.assert_array_equal(got_s.numpy(), want_s)
    else:
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pack_layer_stack_int8_matches_jax(tiny, dtype):
    """The packed int8 weights are the JAX package's after the transpose
    to the (out, in) layout, and the scales equal; the other weights are
    `pack_layer_stack`'s. Exact (the same float32 operations on the same
    compute-dtype weights)."""
    cfg, params, sd = tiny
    jdt, tdt = DTYPES[dtype]
    want = jq.pack_layer_stack_int8(params, [0, 2], jdt)
    got = q8.pack_layer_stack_int8(sd, [0, 2], tdt)
    assert set(got) == set(want)
    for key, value in want.items():
        value = np.asarray(value.astype(jnp.float32) if value.dtype == jnp.bfloat16
                           else value)
        if key in ("wqkv", "wq", "wkv", "w1", "w2"):
            value = value.transpose(0, 2, 1)
        assert got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key].float().numpy() if got[key].is_floating_point()
                                      else got[key].numpy(), value, err_msg=key)
    for name, scale in q8.QUANTIZED:
        assert got[name].dtype == torch.int8 and got[scale].dtype == torch.float32


@pytest.mark.parametrize("mode", ["bf16_out", "f32_bias", "residual"])
def test_gemm_i8_plain_matches_jax(mode):
    """gemm_i8_plain on the int8 operands and scales JAX's `_rowquant` and
    `_colquant` give, against the JAX kernel's `_qmm` product with each
    epilogue (qkv/qc rounded to bf16; hmat + b1; x + deq + b2). The integer
    sums are exact and the float32 epilogue rounds at the same points:
    equal to the bit."""
    rng = np.random.default_rng(2)
    k, n = 256, 384
    x = _rows(3, k=k)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    resid = rng.standard_normal((x.shape[0], n)).astype(np.float32)
    wq_j, cs_j = jq._colquant(jnp.asarray(w))
    xq_j, rs_j = jq._rowquant(jnp.asarray(x))
    deq = jq._qmm(jnp.asarray(x), wq_j, cs_j)
    xq, rs = torch.from_numpy(np.array(xq_j)), torch.from_numpy(np.array(rs_j))
    wq = torch.from_numpy(np.asarray(wq_j).T.copy())
    cs = torch.from_numpy(np.array(cs_j))
    if mode == "bf16_out":
        want = deq.astype(jnp.bfloat16).astype(jnp.float32)
        got = q8.gemm_i8_plain(xq, rs, wq, cs)
        assert got.dtype == torch.bfloat16
    elif mode == "f32_bias":
        want = deq + jnp.asarray(bias)
        got = q8.gemm_i8_plain(xq, rs, wq, cs, bias=torch.from_numpy(bias),
                               out_dtype=torch.float32)
    else:
        want = jnp.asarray(resid) + deq + jnp.asarray(bias)
        got = q8.gemm_i8_plain(xq, rs, wq, cs, bias=torch.from_numpy(bias),
                               residual=torch.from_numpy(resid))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))


LN_PRODUCTS = {  # the three LayerNorm products of a layer: (N, output dtype, bias)
    "qkv_bf16": (384, torch.bfloat16, False),
    "qkv_float32": (384, torch.float32, False),
    "expand_bias": (512, torch.float32, True)}


@pytest.mark.parametrize("mode", sorted(LN_PRODUCTS))
def test_ln_gemm_i8_plain_matches_jax(mode):
    """The LayerNorm product's plain version against the JAX kernel's
    `_ln_f32` then `_qmm` (+ b1 for expand; rounded to bf16 for the bf16
    compute dtype's qkv and qc) on the same rows and JAX `_colquant`
    weights. The LayerNorm statistics may be summed in another order, so a
    rare int8 value may move by one, which moves an output by about one
    quantization step: max-abs within 1e-3 of the output's scale
    (measured: bf16 equal to the bit, float32 within 3.0e-7 of the scale:
    the two epilogues' float32 roundings)."""
    n, out_dtype, with_bias = LN_PRODUCTS[mode]
    rng = np.random.default_rng(8)
    k = 256
    x = _rows(9, k=k)
    ln = _ln_params(10, k=k)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(n)).astype(np.float32)
    wq_j, cs_j = jq._colquant(jnp.asarray(w))
    xn = _ln_f32(jnp.asarray(x), jnp.asarray(ln[0]), jnp.asarray(ln[1]))
    want = jq._qmm(xn, wq_j, cs_j)
    if with_bias:
        want = want + jnp.asarray(b1)
    if out_dtype == torch.bfloat16:
        want = want.astype(jnp.bfloat16).astype(jnp.float32)
    got = q8.ln_gemm_i8_plain(torch.from_numpy(x), tuple(map(torch.from_numpy, ln)),
                              torch.from_numpy(np.asarray(wq_j).T.copy()),
                              torch.from_numpy(np.array(cs_j)),
                              torch.from_numpy(b1) if with_bias else None, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (x.shape[0], n)
    want = np.asarray(want)
    assert np.abs(got.float().numpy() - want).max() <= 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("taps", ["bfloat16", "float32"])
def test_dwconv_gelu_q8_plain_matches_jax(taps):
    """The quantized GELU row's plain version against the JAX kernel's
    stage on the same float32 hidden state: `_dw_fwd` per image, + dwb,
    `_gelu_exact` (an erf polynomial within 1.5e-7 of the exact erf the
    port takes), `_rowquant` over each pixel's channels. The GELU values
    may differ in their last float32 bits, so int8 values within one step
    in under 0.1% of elements and scales within 1e-6 relative (measured:
    bf16 taps int8 equal, float32 taps one value in 8.1e-5 of them moved
    by one; scales within 1.7e-7)."""
    jdt, tdt = DTYPES[taps]
    rng = np.random.default_rng(11)
    b, hw, hid = 3, 4, 256
    h = rng.standard_normal((b * hw * hw, hid)).astype(np.float32)
    dw = (rng.standard_normal((9, hid)) / 3).astype(np.float32)
    dwb = (0.1 * rng.standard_normal(hid)).astype(np.float32)
    dwl = jnp.asarray(dw, jdt).astype(jnp.float32)
    want_q, want_s = [], []
    for i in range(b):
        acc = _dw_fwd(jnp.asarray(h[i * hw * hw:(i + 1) * hw * hw]).reshape(hw, hw, hid),
                      dwl, hw) + jnp.asarray(dwb)
        q, s = jq._rowquant(_gelu_exact(acc).reshape(hw * hw, hid))
        want_q.append(np.asarray(q))
        want_s.append(np.asarray(s))
    want_q, want_s = np.concatenate(want_q), np.concatenate(want_s)
    got_q, got_s = q8.dwconv_gelu_q8_plain(torch.from_numpy(h),
                                           torch.from_numpy(dw).to(tdt),
                                           torch.from_numpy(dwb), hw)
    assert got_q.dtype == torch.int8 and got_q.shape == h.shape
    assert got_s.dtype == torch.float32 and got_s.shape == (h.shape[0], 1)
    diff = np.abs(got_q.numpy().astype(int) - want_q.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-6, atol=0)


def test_fused_int8_stages_compose_the_unfused_ones():
    """The route's two fused stages are the compositions they replace, to
    the bit: `ln_gemm_i8_plain` is `rowquant_plain(x, ln)` then
    `gemm_i8_plain`, `dwconv_gelu_q8_plain` is the float32-out
    `dwconv_gelu_plain` then `rowquant_plain`; and a layer launches no
    rowquant and no float32-out dwconv_gelu, eight launches in all."""
    g = torch.Generator().manual_seed(12)
    x = torch.randn(32, 128, generator=g) * 2
    ln = (1 + 0.1 * torch.randn(128, generator=g), 0.1 * torch.randn(128, generator=g))
    wq, cs = q8.colquant(torch.randn(256, 128, generator=g) / 12)
    b1 = torch.randn(256, generator=g)
    xq, rs = q8.rowquant_plain(x, ln)
    torch.testing.assert_close(
        q8.ln_gemm_i8_plain(x, ln, wq, cs, b1, out_dtype=torch.float32),
        q8.gemm_i8_plain(xq, rs, wq, cs, b1, out_dtype=torch.float32), atol=0, rtol=0)
    h = torch.randn(2 * 16, 256, generator=g)
    dw, dwb = torch.randn(9, 256, generator=g).bfloat16(), torch.randn(256, generator=g)
    got = q8.dwconv_gelu_q8_plain(h, dw, dwb, 4)
    want = q8.rowquant_plain(fs.dwconv_gelu_plain(h, dw, dwb, 4, out_dtype=torch.float32))
    for u, v in zip(got, want):
        torch.testing.assert_close(u, v, atol=0, rtol=0)
    assert sum(q8.LAUNCHES_PER_LAYER.values()) == 8
    assert "rowquant" not in q8.LAUNCHES_PER_LAYER
    assert "dwconv_gelu" not in q8.LAUNCHES_PER_LAYER


@pytest.mark.parametrize("heads", [1, 2, 3, 12, 16])
def test_dwconv_gelu_q8_plan_fits_every_width(heads):
    """The quantizing depthwise kernel's clusters at every width the JAX
    package runs (hidden = 4 x 64 x heads) on the engine's grids (hw <= 16):
    at most 8 ranks, each a whole number of 128-channel groups (a warp's
    lanes share their pixels), a run of 4 or 8 pixels a thread, the most
    of the block's 384 threads at work, and a ring of 4 grid rows within
    the card's 227 KB of shared memory; a grid too wide, or channels not in
    128s, raise ValueError."""
    c = 256 * heads
    for hw in (2, 4, 8, 16):
        ranks, tseg = q8.dwconv_gelu_q8_plan(hw, c)
        assert ranks in (1, 2, 4, 8) and c % (128 * ranks) == 0 and tseg in (4, 8)
        used = c // ranks // 4 * -(-hw // tseg)
        assert used <= q8.Q8_THREADS
        assert 4 * (hw + 2) * (c // ranks) * 4 < fs.SMEM_PER_BLOCK
        for r in (1, 2, 4, 8):  # no layout that fits puts more threads to work
            for t in (4, 8):
                if c % (128 * r) == 0 and 4 * (hw + 2) * (c // r) * 4 < 200_000:
                    other = c // r // 4 * -(-hw // t)
                    assert other > q8.Q8_THREADS or other <= used
    assert q8.dwconv_gelu_q8_plan(16, 3072) == (4, 8)
    with pytest.raises(ValueError):
        q8.dwconv_gelu_q8_plan(256, c)
    with pytest.raises(ValueError):
        q8.dwconv_gelu_q8_plan(16, c + 64)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_layer_stack_int8_matches_jax_kernel(tiny, dtype):
    """One W8A8 layer: the port's stack (plain stages on the CPU) against
    the JAX kernel in interpret mode. Only summation order and the TPU
    kernel's erf polynomial (|err| < 1.5e-7, against the port's exact erf)
    differ, which can flip a rare int8 value by one, and one flip moves an
    output by about one quantization step (its row's and column's scales).
    max-abs within 0.01 x the output's scale in float32 (measured 1.7e-3
    x, rel-L2 4.1e-4) and 0.02 x in bf16, the bf16 kernel tests' bound
    (measured 2.6e-3 x, rel-L2 5.5e-4)."""
    cfg, params, sd = tiny
    jdt, tdt = DTYPES[dtype]
    hw = cfg.image_size // cfg.patch_size
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, hw * hw, cfg.embed_dim)).astype(np.float32)
    cond = rng.standard_normal((2, 2, cfg.embed_dim)).astype(np.float32)
    want = np.asarray(jq.fused_layer_stack_int8(
        jnp.asarray(x, jdt), jnp.asarray(cond, jdt),
        jq.pack_layer_stack_int8(params, [1], jdt), hw=hw, n_heads=2,
        interpret=True).astype(jnp.float32))
    got = q8.fused_layer_stack_int8(
        torch.from_numpy(x).to(tdt), torch.from_numpy(cond).to(tdt),
        q8.pack_layer_stack_int8(sd, [1], tdt), hw=hw, n_heads=2)
    assert got.dtype == tdt and got.shape == x.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err < (0.01 if dtype == "float32" else 0.02) * np.abs(want).max(), err


def _engine_inputs(cfg, seed, b=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 4, cfg.image_size, cfg.image_size)).astype(np.float32)
    nl = rng.uniform(0.01, 0.99, (b, 1)).astype(np.float32)
    label = rng.standard_normal((b, cfg.text_emb_size)).astype(np.float32)
    return x, nl, label


def _port_engine(cfg, dtype):
    return make_fused_apply(pc.DenoiserConfig(**asdict(cfg)), compute_dtype=dtype,
                            quantize="int8")


def _sd_in(sd, dtype):
    model = Denoiser.from_config(pc.DenoiserConfig(), dtype=dtype)
    model.load_state_dict(sd)
    return model.state_dict()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_engine_matches_jax_engine(tiny, dtype):
    """The whole int8 engine (prologue, three W8A8 layers, epilogue) against
    the JAX engine with its int8 kernel in interpret mode; rare int8 flips
    as for one layer. max-abs within 0.01 x the output's scale in float32
    (measured 1.8e-3 x, rel-L2 1.7e-3) and 0.02 x in bf16, the bf16 engine
    test's bound (measured 8.6e-3 x, rel-L2 8.2e-3)."""
    cfg, params, sd = tiny
    jdt, tdt = DTYPES[dtype]
    x, nl, label = _engine_inputs(cfg, seed=5, b=2)
    want = np.asarray(jax_make_fused_apply(cfg, compute_dtype=jdt, interpret=True,
                                           quantize="int8")(params, x, nl, label))
    with torch.no_grad():
        got = _port_engine(cfg, tdt)(_sd_in(sd, tdt), *map(torch.from_numpy, (x, nl, label)))
    assert got.shape == want.shape and torch.isfinite(got).all()
    bound = 0.01 if dtype == "float32" else 0.02
    err = np.abs(got.numpy() - want).max()
    assert err < bound * np.abs(want).max(), err


def test_int8_engine_tracks_linen(tiny):
    """tests/test_fused_int8.py's gate for the lossy int8 engine, here for
    the port's: against the float32 linen Denoiser of the JAX package,
    cosine > 0.995 and max-abs < 0.15 x the output's scale (measured on
    the port: cosine 0.99997, max-abs 0.010 x scale)."""
    cfg, params, sd = tiny
    x, nl, label = _engine_inputs(cfg, seed=7, b=4)
    model = JaxDenoiser(**asdict(cfg))
    want = np.asarray(jax.jit(lambda p, *a: model.apply({"params": p}, *a))(
        params, x, nl, label))
    with torch.no_grad():
        got = _port_engine(cfg, torch.float32)(sd, *map(torch.from_numpy,
                                                        (x, nl, label))).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _cosine(got, want) > 0.995, _cosine(got, want)
    assert np.abs(got - want).max() < 0.15 * np.abs(want).max()


def test_int8_prepare_is_reusable(tiny):
    """prepare() feeds apply_prepared repeatedly (the sampling loop's
    contract) with equal outputs, and the packed weights have the int8 /
    float32 / compute dtypes the kernels take."""
    cfg, _, sd = tiny
    engine = _port_engine(cfg, torch.bfloat16)
    sd = _sd_in(sd, torch.bfloat16)
    prepared = engine.prepare(sd)
    assert len(prepared["layers"]) == cfg.n_layers
    for layer in prepared["layers"]:
        for name, scale in q8.QUANTIZED:
            assert layer[name].dtype == torch.int8 and layer[scale].dtype == torch.float32
        assert layer["wkv"].dtype == torch.bfloat16 and layer["dw"].dtype == torch.bfloat16
        assert layer["b1"].dtype == torch.float32
    x, nl, label = map(torch.from_numpy, _engine_inputs(cfg, seed=3, b=2))
    with torch.no_grad():
        y1 = engine.apply_prepared(prepared, x, nl, label)
        y2 = engine.apply_prepared(prepared, x, nl, label)
    torch.testing.assert_close(y1, y2, atol=0, rtol=0)


def _tiny_ltd(**kw):
    kw.setdefault("vae_cfg", pc.VaeConfig(block_out_channels=(8, 16),
                                          layers_per_block=1))
    kw.setdefault("clip_cfg", pc.ClipConfig(width=64, heads=2, layers=2))
    return pc.LTDConfig(**kw)


def test_pipeline_on_cpu_ignores_int8():
    """On the CPU, as in the JAX package (sampling/pipeline.py:230-231), no
    engine is built, so quantize="int8" gives the same images as None."""
    base = DiffusionTransformer(_tiny_ltd(), device="cpu")
    int8 = DiffusionTransformer(_tiny_ltd(quantize="int8"), device="cpu")
    assert int8.diffuser.fast_apply is None
    kw = dict(num_imgs=2, n_iter=3, seed=5, sampler="ddim")
    np.testing.assert_array_equal(int8.generate_array_from_text("a cat", **kw),
                                  base.generate_array_from_text("a cat", **kw))


def test_unknown_quantize_raises_on_every_device():
    """An unknown quantize mode raises ValueError from the engine and from
    the pipeline, on the CPU too (where the JAX package ignores it)."""
    with pytest.raises(ValueError, match="quantize"):
        make_fused_apply(pc.DenoiserConfig(), quantize="int4")
    with pytest.raises(ValueError, match="quantize"):
        DiffusionTransformer(_tiny_ltd(quantize="fp8"), device="cpu")
    assert make_fused_apply(pc.DenoiserConfig(), quantize="int8").quantize == "int8"


def test_int8_deployment_config_roundtrips_through_json(tmp_path):
    """The service's `--config` JSON carries the int8 deployment."""
    path = tmp_path / "ltd.json"
    path.write_text(pc.config_to_json(_tiny_ltd(quantize="int8")))
    cfg = pc.ltd_config_from_json(str(path))
    assert cfg == _tiny_ltd(quantize="int8") and cfg.quantize == "int8"


class _SpyEngine:
    """Stands in for the int8 engine; records its forwards."""

    def __init__(self, cfg):
        self.engine = make_fused_apply(cfg, compute_dtype=torch.float32,
                                       quantize="int8")
        self.calls = 0

    def prepare(self, sd):
        return self.engine.prepare(sd)

    def apply_prepared(self, *args):
        self.calls += 1
        return self.engine.apply_prepared(*args)


@pytest.mark.parametrize("image_size,size,engine", [
    (64, 64, False), (16, 32, False), (16, 16, True)],
    ids=["32x32_native", "32x32_resized", "8x8_native"])
def test_int8_engine_only_on_native_grids_of_at_most_256_tokens(image_size, size,
                                                                engine):
    """A 32 x 32-token grid (a 512 px deployment, or a 256 px model on a
    512 px grid) never calls the int8 engine: the generator's gate is the
    bf16 engine's, so such a deployment runs the Denoiser (K3/K5 on CUDA)
    and no K7, as in JAX."""
    cfg = pc.DenoiserConfig(image_size=image_size, embed_dim=64, n_layers=1)
    model = Denoiser.from_config(cfg).eval()
    spy = _SpyEngine(cfg)
    gen = td.DiffusionGenerator(model, fast_apply=spy, device="cpu")
    assert gen.uses_engine(size) == engine
    _, lat = gen.generate(np.zeros((1, 768), np.float32), n_iter=2, num_imgs=1,
                          img_size=size)
    assert lat.shape == (1, 4, size, size) and torch.isfinite(lat).all()
    assert spy.calls == (2 if engine else 0)


def _stage_args(name, device):
    g = torch.Generator().manual_seed(6)
    m, k, n = 64, 256, 384

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device=device, dtype=dtype)

    if name == "rowquant":
        return (r(m, k),), {"ln": (r(k), r(k))}
    if name == "dwconv_gelu_q8":  # 4 images of a 4 x 4 grid
        return (r(m, k), r(9, k, dtype=torch.bfloat16), r(k), 4), {}
    xq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).to(device)
    wq = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).to(device)
    if name == "ln_gemm_i8":
        return (r(m, k), (r(k), r(k)), wq, r(1, n).abs()), {"bias": r(n),
                                                             "out_dtype": torch.float32}
    return (xq, r(m, 1).abs(), wq, r(1, n).abs()), {"bias": r(n), "residual": r(m, n)}


@pytest.mark.parametrize("name", q8.KERNELS)
def test_int8_wrapper_dispatches_by_device(name):
    """CPU tensors take the plain version (and count no launch); tensors on
    any device other than CUDA raise instead of falling back."""
    q8.reset_launch_counts()
    wrapper, plain = getattr(q8, name), getattr(q8, f"{name}_plain")
    args, kw = _stage_args(name, "cpu")
    torch.testing.assert_close(wrapper(*args, **kw), plain(*args, **kw), atol=0, rtol=0)
    assert q8.LAUNCHES == {k: 0 for k in q8.KERNELS}
    args, kw = _stage_args(name, "meta")
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args, **kw)


def test_int8_stages_match_independent_forms():
    """Each plain stage against a formulation that shares no code with it:
    F.layer_norm then a per-row division by the scale; an int64 integer
    product; F.conv2d (groups=C) + F.gelu for the float32-out depthwise
    stage; the LN-free cross-attention against the one with LN3. Exact
    where the arithmetic is integer, else 1e-5 (summation order)."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(32, 256, generator=g) * 3
    scale, shift = torch.randn(256, generator=g), torch.randn(256, generator=g)
    q, rs = q8.rowquant_plain(x, (scale, shift))
    y = F.layer_norm(x, (256,), scale, shift, 1e-5)
    torch.testing.assert_close(rs, y.abs().amax(-1, keepdim=True) / 127, atol=0, rtol=1e-5)
    assert q.abs().max() == 127
    assert ((q.float() - y / rs).abs() <= 0.5 + 1e-3).all()

    wq = torch.randint(-127, 128, (128, 256), generator=g, dtype=torch.int8)
    cs = torch.rand(1, 128, generator=g)
    acc = (q.long() @ wq.long().T).float()
    torch.testing.assert_close(q8.gemm_i8_plain(q, rs, wq, cs, out_dtype=torch.float32),
                               acc * rs * cs, atol=0, rtol=0)

    b, hw, hidden = 2, 4, 64
    h = torch.randn(b * hw * hw, hidden, generator=g)
    dw = torch.randn(9, hidden, generator=g).bfloat16()
    dwb = torch.randn(hidden, generator=g)
    grid = h.reshape(b, hw, hw, hidden).permute(0, 3, 1, 2)
    want = F.gelu(F.conv2d(grid, dw.float().T.reshape(hidden, 1, 3, 3), dwb, padding=1,
                           groups=hidden)).permute(0, 2, 3, 1).reshape(-1, hidden)
    got = fs.dwconv_gelu_plain(h, dw, dwb, hw, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)

    n, d, heads = hw * hw, 128, 2
    qc, kv = torch.randn(b * n, d, generator=g), torch.randn(2 * b, 2 * d, generator=g)
    res = torch.randn(b * n, d, generator=g)
    x_ln, xn = fs.cross_attention_plain(qc, kv, res, (scale[:d], shift[:d]), heads, n)
    x_no, none = fs.cross_attention_plain(qc, kv, res, None, heads, n)
    assert none is None and xn is not None
    torch.testing.assert_close(x_no, x_ln, atol=0, rtol=0)
