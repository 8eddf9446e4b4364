"""K1 and K7 with float32 weights, the JAX package's default
configuration (`DenoiserLoad.dtype="float32"`), on the CPU.

- The port's float32 fused engine, K1's and K7's (quantize="int8"), against
  the JAX engine with its Pallas kernels in interpret mode, at embed_dim 64
  and 192 (1 and 3 heads, 2 layers, a 4 x 4 grid): the stacks' plain
  versions, which the CPU runs, at the bounds of
  tests/test_torch_port_widths.py (float32: atol 1e-4, rtol 1e-3; W8A8:
  max-abs 0.01 of the output's scale).
- The wrappers' float32 dispatch without a card: `fused_stack._on_cuda`,
  `_stream` and the kernels' library replaced by stand-ins, each wrapper
  given float32 operands calls its float32 body's C entry point (and
  counts it in `fused_stack_f32.LAUNCHES`), bf16 operands the bf16 one;
  the dtype combinations the bodies do not take raise ValueError.
- A rehearsal of the CUDA wiring: `DiffusionTransformer` on "cuda" with
  float32 weights builds a float32 engine (the modules' moves to the card
  mapped to the CPU), a float32 linen-path deployment (past 16 x 16
  tokens, or the "mlp" FFN) builds its float32 Denoiser with the JAX
  package's kernel flags, float16 raises naming ROADMAP item 4, and the
  sampler's graph key holds the engine's compute dtype, so a float32 loop
  is a graph of its own.
The kernels themselves are held against these plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py's [float32-kernels])."""

import contextlib
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.configs import DenoiserConfig
from transformer_latent_diffusion_tpu.models import Denoiser as JaxDenoiser
from transformer_latent_diffusion_tpu.models.fast_denoiser import (
    make_fused_apply as jax_make_fused_apply,
)
from transformer_latent_diffusion_tpu.utils import init_denoiser_params
from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import make_fused_apply
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.ops import fused_stack_f32 as f32
from transformer_latent_diffusion_tpu_torch.ops import fused_stack_int8 as q8
from transformer_latent_diffusion_tpu_torch.sampling.diffusion import DiffusionGenerator
from transformer_latent_diffusion_tpu_torch.sampling.pipeline import (
    DiffusionTransformer,
    denoiser_kernel_flags,
)

torch.set_num_threads(2)

WIDTHS = (64, 192)
HW = 4


@pytest.fixture(scope="module", params=WIDTHS, ids=lambda d: f"d{d}")
def model(request):
    cfg = replace(DenoiserConfig(), embed_dim=request.param, n_layers=2,
                  image_size=2 * HW)
    params = init_denoiser_params(JaxDenoiser(**asdict(cfg)), cfg)
    sd = convert.denoiser_state_dict(jax.tree.map(np.asarray, params), cfg)
    return cfg, params, {k: torch.from_numpy(v) for k, v in sd.items()}


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["k1", "k7"])
def test_float32_engine_matches_jax_at_width(model, quantize):
    cfg, params, sd = model
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 2 * HW, 2 * HW)).astype(np.float32)
    nl = np.array([[0.3], [0.8]], np.float32)
    label = rng.standard_normal((2, cfg.text_emb_size)).astype(np.float32)
    jengine = jax_make_fused_apply(cfg, compute_dtype=jnp.float32, interpret=True,
                                   quantize=quantize)
    want = np.asarray(jengine(params, x, nl, label))
    engine = make_fused_apply(pc.DenoiserConfig(**asdict(cfg)),
                              compute_dtype=torch.float32, quantize=quantize)
    prepared = engine.prepare(sd)
    assert all(t.dtype in (torch.float32, torch.int8)
               for layer in prepared["layers"] for t in layer.values())
    with torch.no_grad():
        got = engine.apply_prepared(prepared, *(torch.from_numpy(a) for a in (x, nl, label)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if quantize is None:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-3)
    else:
        assert np.abs(got.numpy() - want).max() < 0.01 * np.abs(want).max()


# ------------------------------ the wrappers' dispatch ------------------------------


class _FakeLib:
    """The kernels' library: records each entry point called, launches
    nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name == "ltd_ln_gemm_scratch_rows":
            return lambda *a: 0

        def call(*args):
            self.calls.append(name)
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors pass for CUDA ones: the wrappers' checks, allocation and
    dispatch run, the library records the entry points."""
    lib = _FakeLib()
    meta = torch.device("meta")
    monkeypatch.setattr(fs, "_on_cuda", lambda name, *ts: meta)
    monkeypatch.setattr(fs, "_stream", lambda dev: None)
    monkeypatch.setattr(fs, "tma_operand", lambda t: True)
    monkeypatch.setattr(fs, "load_library", lambda: lib)
    monkeypatch.setattr(f32, "load_library", lambda: lib)
    monkeypatch.setattr(fs, "_ptr", lambda t: None)
    fs.reset_launch_counts()
    f32.reset_launch_counts()
    yield lib
    fs.reset_launch_counts()
    f32.reset_launch_counts()


def _stage_call(name, dt):
    b, hw, d, heads = 2, 4, 128, 2
    n, m = hw * hw, 2 * hw * hw

    def t(*shape, dtype=dt):
        return torch.empty(*shape, dtype=dtype, device="meta")

    f = torch.float32
    if name == "ln_gemm":
        return lambda: fs.ln_gemm(t(m, d, dtype=f), t(3 * d, d), ln=(t(d, dtype=f), t(d, dtype=f)))
    if name == "self_attention":
        return lambda: fs.self_attention(t(m, 3 * d), t(m, d, dtype=f), heads, n)
    if name == "cross_attention":
        return lambda: fs.cross_attention(t(m, d), t(2 * b, 2 * d), t(m, d, dtype=f),
                                          (t(d, dtype=f), t(d, dtype=f)), heads, n)
    return lambda: fs.dwconv_gelu(t(m, 4 * d, dtype=f), t(9, 4 * d), t(4 * d, dtype=f), hw)


@pytest.mark.parametrize("name", fs.KERNELS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_sends_float32_to_its_body(fake_card, name, dtype):
    dt = getattr(torch, dtype)
    out = _stage_call(name, dt)()
    out = out[1] if isinstance(out, tuple) else out
    if dtype == "float32":
        assert fake_card.calls == [{"ln_gemm": "ltd_ln_gemm_f32",
                                    "self_attention": "ltd_self_attention_f32",
                                    "cross_attention": "ltd_cross_attention_f32",
                                    "dwconv_gelu": "ltd_dwconv_gelu"}[name]]
        assert f32.LAUNCHES == {k: int(k == f"{name}_f32") for k in f32.KERNELS}
        assert not any(fs.LAUNCHES.values())
        assert out.dtype == torch.float32  # float32 out, LN3 rows, GELU
    else:
        assert fake_card.calls == [f"ltd_{name}"]
        assert fs.LAUNCHES == {k: int(k == name) for k in fs.KERNELS}
        assert not any(f32.LAUNCHES.values())


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


BAD_FLOAT32_CALLS = {
    "ln_gemm bf16 a without ln": lambda: fs.ln_gemm(_meta(8, 64, dtype=torch.bfloat16),
                                                    _meta(16, 64)),
    "ln_gemm w_transposed": lambda: fs.ln_gemm(_meta(8, 64), _meta(64, 16), w_transposed=True,
                                               ln=(_meta(64), _meta(64))),
    "ln_gemm bf16 out": lambda: fs.ln_gemm(_meta(8, 64), _meta(16, 64),
                                           out_dtype=torch.bfloat16),
    "ln_gemm return_xn": lambda: fs.ln_gemm(_meta(8, 64), _meta(16, 64), return_xn=True),
    "ln_gemm K % 8": lambda: fs.ln_gemm(_meta(8, 60), _meta(16, 60)),
    "self_attention bf16 residual": lambda: fs.self_attention(
        _meta(32, 384), _meta(32, 128, dtype=torch.bfloat16), 2, 16),
    "self_attention N > 256": lambda: fs.self_attention(_meta(514, 192), _meta(514, 64), 1, 257),
    "cross_attention summed": lambda: fs.cross_attention(
        _meta(32, 128), _meta(4, 256), _meta(32, 128), None, 2, 16, summed=True),
    "cross_attention bf16 kv": lambda: fs.cross_attention(
        _meta(32, 128), _meta(4, 256, dtype=torch.bfloat16), _meta(32, 128), None, 2, 16),
    "dwconv_gelu bf16 h": lambda: fs.dwconv_gelu(_meta(32, 64, dtype=torch.bfloat16),
                                                 _meta(9, 64), _meta(64), 4),
    "dwconv_gelu return_c": lambda: fs.dwconv_gelu(_meta(32, 64), _meta(9, 64), _meta(64), 4,
                                                   return_c=True, c_dtype=torch.bfloat16),
    "dwconv_gelu mode none": lambda: fs.dwconv_gelu(_meta(32, 64), _meta(9, 64), _meta(64), 4,
                                                    dw_mode="none"),
    "dwconv_gelu bf16 out": lambda: fs.dwconv_gelu(_meta(32, 64), _meta(9, 64), _meta(64), 4,
                                                   out_dtype=torch.bfloat16),
}


@pytest.mark.parametrize("case", sorted(BAD_FLOAT32_CALLS))
def test_float32_bodies_refuse_what_they_do_not_take(fake_card, case):
    with pytest.raises(ValueError):
        BAD_FLOAT32_CALLS[case]()
    assert fake_card.calls == []


def test_per_layer_launches_name_the_float32_bodies():
    """The launches of one engine layer by compute dtype (what the smoke's
    exact launch counts use)."""
    assert f32.launches_per_layer(torch.float32) == {
        "ln_gemm_f32": 5, "self_attention_f32": 1, "cross_attention_f32": 1,
        "dwconv_gelu_f32": 1}
    assert f32.launches_per_layer(torch.float32, "int8") == {
        "ln_gemm_i8": 3, "gemm_i8": 1, "dwconv_gelu_q8": 1, "ln_gemm_f32": 1,
        "self_attention_f32": 1, "cross_attention_f32": 1}
    assert f32.launches_per_layer(torch.bfloat16) == fs.LAUNCHES_PER_LAYER
    assert f32.launches_per_layer(torch.bfloat16, "int8") == q8.LAUNCHES_PER_LAYER


# ------------------------------ the CUDA wiring, rehearsed ------------------------------


@contextlib.contextmanager
def _cuda_on_cpu(monkeypatch):
    """torch.cuda.is_available() true, and moves of modules to "cuda" kept on
    the CPU, so a transformer builds as it would on a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    orig = torch.nn.Module.to

    def to(self, *args, **kwargs):
        args = tuple("cpu" if isinstance(a, (str, torch.device))
                     and torch.device(a).type == "cuda" else a for a in args)
        if "device" in kwargs:
            kwargs["device"] = "cpu"
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(torch.nn.Module, "to", to)
    yield


def _tiny_ltd(dtype, **den):
    return pc.LTDConfig(
        denoiser_cfg=pc.DenoiserConfig(image_size=8, embed_dim=64, n_layers=2,
                                       noise_embed_dims=64, **den),
        denoiser_load=pc.DenoiserLoad(dtype=dtype),
        vae_cfg=pc.VaeConfig(block_out_channels=(8, 16), layers_per_block=1),
        clip_cfg=pc.ClipConfig(width=64, heads=2, layers=2))


def test_cuda_wiring_rehearsal(monkeypatch):
    """On "cuda": the JAX default (float32) builds the float32 engine, bf16
    the bf16 one, W8A8 with float32 the float32 K7; a float32 deployment
    past 16 x 16 tokens, and one with the "mlp" FFN, build the float32
    linen path (flash attention everywhere, the fused MLP on a 32 x 32
    grid: the JAX package's flags); float16 raises at construction,
    naming ROADMAP item 4."""
    with _cuda_on_cpu(monkeypatch):
        for dtype, quantize, want in (("float32", None, torch.float32),
                                      ("bfloat16", None, torch.bfloat16),
                                      ("float32", "int8", torch.float32)):
            cfg = replace(_tiny_ltd(dtype), quantize=quantize)
            tr = DiffusionTransformer(cfg, device="cuda")
            engine = tr.diffuser.fast_apply
            assert engine is not None and engine.dtype == want
            assert engine.quantize == quantize and tr.diffuser.model.dtype == want
        with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
            DiffusionTransformer(_tiny_ltd("float16"), device="cuda")
        hires = replace(_tiny_ltd("float32"), denoiser_cfg=pc.DenoiserConfig(
            image_size=64, embed_dim=64, n_layers=2, noise_embed_dims=64))
        for cfg, fused_mlp in ((hires, True), (_tiny_ltd("float32", mlp_class="mlp"), False)):
            model = DiffusionTransformer(cfg, device="cuda").diffuser.model
            assert model.dtype == torch.float32
            assert (model.use_pallas, model.fused_mlp_vjp) == (True, fused_mlp)
            assert {"use_pallas": True, "fused_mlp_vjp": fused_mlp} == denoiser_kernel_flags(
                cfg, "cuda")


def test_graph_key_holds_the_engine_dtype():
    """The sampler's graph key names the engine's compute dtype: the float32
    and bf16 loops of one model are two graphs. The float32 engine's loop
    samples finite latents on the CPU (its plain versions)."""
    cfg = pc.DenoiserConfig(image_size=8, embed_dim=64, n_layers=2, noise_embed_dims=64)
    model = Denoiser.from_config(cfg).eval()
    labels = np.ones((2, cfg.text_emb_size), np.float32)
    keys = {}
    for dt in (torch.float32, torch.bfloat16):
        gen = DiffusionGenerator(model, fast_apply=make_fused_apply(cfg, compute_dtype=dt),
                                 device="cpu")
        plan = gen.plan_loop(labels, num_imgs=2, img_size=8, n_iter=3, seed=0)
        keys[dt] = plan.key
        assert plan.key[0] == ("engine", None, str(dt))
        if dt == torch.float32:
            assert torch.isfinite(plan.run_eager()).all()
    assert keys[torch.float32] != keys[torch.bfloat16]
