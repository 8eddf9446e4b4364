"""Float32 training past 256 tokens (`TrainConfig(compute_dtype="float32")`,
the JAX package's default: finetune_highres to 512 and 1024 px, multires
buckets past 256 tokens). There the self-attention's backward runs K4a/K4b's
float32 body (`flash_attention_bwd_f32`, after K3's float32 forward with
its row log-sum-exp) and the sep-conv MLP's backward K5's float32 route
(`ln_gemm_f32`, `dwconv_gelu_f32`'s row band with c, `ln_gemm_f32` on W2
as stored, `dwconv_gelu_bwd`'s float32 row bands, `weight_grad_f32` twice,
`colsum`, `ln_gemm_f32`).

- The wrappers' float32 dispatch without a card (the kernels' library and
  the device checks replaced by stand-ins, meta tensors for CUDA ones):
  each float32 call that needs a gradient takes its float32 bodies with
  exact launches, and the backward's route (K4a, K4b, plain) follows the
  JAX package's gates in float32 too.
- `train.main` with a float32 compute dtype on "cuda" gets past the
  compute-dtype check at 400 tokens and with a bucket past 256 tokens
  (the next thing it does is read the data, whose files do not exist).
- A float32 block of 1024 tokens built with train.main's CUDA flags
  (fused_layer_vjp, use_pallas; the port's wrappers on their plain
  versions here) against the JAX float32 block with K3, K4a and K5 in
  interpret mode: output and every gradient.
The kernels themselves are held against their plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py's
[float32-hires-train-kernels])."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.models.blocks import DecoderBlock as JaxDecoderBlock
from transformer_latent_diffusion_tpu.ops import attention as jatt
from transformer_latent_diffusion_tpu.utils.goldens import rel_l2
from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models import blocks
from transformer_latent_diffusion_tpu_torch.ops import attention as att
from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp_f32 as lv32
from transformer_latent_diffusion_tpu_torch.ops import fused_mlp_vjp as fm
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.ops import fused_stack_f32 as f32
from transformer_latent_diffusion_tpu_torch.train import train as ttrain

torch.set_num_threads(2)

F32 = torch.float32
COUNTED = (att, fm, fs, f32, lv, lv32)


# ------------------------------ the wrappers' dispatch ------------------------------


class _RecordingLib:
    """The kernels' library: records each entry point called with its
    arguments, launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name == "ltd_ln_gemm_scratch_rows":  # a size query, no launch
            return lambda *a: 0

        def call(*args):
            self.calls.append((name, args))
            return 0
        return call

    def names(self):
        return [name for name, _ in self.calls]


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors pass for CUDA ones: the wrappers' checks, allocation,
    plans and dispatch run, the library records the entry points."""
    lib = _RecordingLib()
    meta = torch.device("meta")
    monkeypatch.setattr(att, "_cuda_device", lambda t: t.device)
    monkeypatch.setattr(fm, "_require_cuda", lambda name, x: None)
    for mod in (fs, lv):
        monkeypatch.setattr(mod, "_on_cuda", lambda name, *ts: meta)
    for mod in (att, fs, lv):
        monkeypatch.setattr(mod, "_stream", lambda dev: None)
        # a null pointer for an absent operand, as the wrappers pass it
        monkeypatch.setattr(mod, "_ptr", lambda t: None if t is None else 16)
    for mod in (att, fs, f32, lv, lv32):
        monkeypatch.setattr(mod, "load_library", lambda: lib)
    monkeypatch.setattr(fs, "tma_operand", lambda t: True)
    monkeypatch.setattr(lv, "_zeroed_counters",
                        lambda dev, n: torch.zeros(n, dtype=torch.int32, device=dev))

    def plan_on(m, n, k, dev, tile=lv.WG_TILE, stage_rows=lv.WG_STAGE_ROWS):
        plan = lv.weight_grad_plan(m, n, k, 132, tile, stage_rows)
        return plan, torch.empty(len(plan.table()), dtype=torch.int32, device=dev)
    monkeypatch.setattr(lv, "_plan_on", plan_on)
    for mod in COUNTED:
        mod.reset_launch_counts()
    yield lib
    for mod in COUNTED:
        mod.reset_launch_counts()


def _launches():
    return {k: v for mod in COUNTED for k, v in mod.LAUNCHES.items() if v}


def _meta(*shape, dtype=F32, grad=False):
    return torch.empty(*shape, dtype=dtype, device="meta", requires_grad=grad)


def _qkv(n, b=2, heads=2, grad=False):
    """q, k, v as the model passes them: column views of a fused (B, N, 3D)."""
    return _meta(b, n, 3 * 64 * heads, grad=grad).chunk(3, dim=-1)


def _mlp_args(hw=32, d=128, grad=False):
    hidden = 4 * d
    return (_meta(2, hw * hw, d, grad=grad), _meta(hidden, d, grad=grad), _meta(hidden),
            _meta(9, hidden, grad=grad), _meta(hidden), _meta(d, hidden, grad=grad),
            _meta(d))


def _attention_grad():
    q, k, v = _qkv(1024, grad=True)
    att.flash_attention(q, k, v, 2).sum().backward()


def _attention_bwd():
    q, k, v = _qkv(1024)
    o, lse = att._flash_forward(q, k, v, 2, with_lse=True)
    grads = att.flash_attention_bwd(q, k, v, _meta(2, 1024, 128), 2, o=o, lse=lse)
    assert all(t.dtype == F32 and t.shape == (2, 1024, 128) for t in grads)


def _mlp_grad():
    fm.fused_mlp_sepconv(*_mlp_args(grad=True), 32).sum().backward()


def _mlp_bwd():
    x, w1, b1, dw, dwb, w2, _ = _mlp_args()
    grads = fm.fused_mlp_sepconv_bwd(x, _meta(*x.shape), w1, b1, dw, dwb, w2, 32)
    assert [tuple(t.shape) for t in grads] == [(2, 1024, 128), (512, 128), (512,), (9, 512),
                                              (512,), (128, 512), (128,)]
    assert all(t.dtype == F32 for t in grads)


K5_BWD_F32 = {**fm.ROUTE_LAUNCHES["fused_mlp_sepconv_bwd_f32"], "fused_mlp_sepconv_bwd_f32": 1}
K5_FWD_F32 = {**fm.ROUTE_LAUNCHES["fused_mlp_sepconv_f32"], "fused_mlp_sepconv_f32": 1}
# each call: its entry points in order, and its launches
GRAD_CALLS = {
    "flash_attention with a gradient": (
        _attention_grad,
        ["ltd_flash_attention_f32", "ltd_flash_attention_bwd_f32_dq",
         "ltd_flash_attention_bwd_f32_dkv"],
        {"flash_attention_f32": 1, "flash_attention_bwd_f32": 2}),
    "flash_attention_bwd": (
        _attention_bwd,
        ["ltd_flash_attention_f32", "ltd_flash_attention_bwd_f32_dq",
         "ltd_flash_attention_bwd_f32_dkv"],
        {"flash_attention_f32": 1, "flash_attention_bwd_f32": 2}),
    "fused_mlp_sepconv with a gradient": (
        _mlp_grad,
        ["ltd_ln_gemm_f32", "ltd_dwconv_gelu", "ltd_ln_gemm_f32",  # the forward
         "ltd_ln_gemm_f32", "ltd_dwconv_gelu", "ltd_ln_gemm_f32", "ltd_dwconv_gelu_bwd",
         "ltd_weight_grad_f32", "ltd_colsum", "ltd_weight_grad_f32", "ltd_ln_gemm_f32"],
        {k: K5_FWD_F32.get(k, 0) + K5_BWD_F32.get(k, 0) for k in {*K5_FWD_F32, *K5_BWD_F32}}),
    "fused_mlp_sepconv_bwd": (
        _mlp_bwd,
        ["ltd_ln_gemm_f32", "ltd_dwconv_gelu", "ltd_ln_gemm_f32", "ltd_dwconv_gelu_bwd",
         "ltd_weight_grad_f32", "ltd_colsum", "ltd_weight_grad_f32", "ltd_ln_gemm_f32"],
        K5_BWD_F32),
}


@pytest.mark.parametrize("case", sorted(GRAD_CALLS))
def test_float32_gradients_take_their_float32_bodies(fake_card, case):
    """Each float32 call that needs a gradient on the card makes exactly
    its float32 launches and no bf16 one: K3's float32 body with the
    log-sum-exp (its lse pointer set), the two kernels of the float32 K4
    body, and K5's float32 backward route (its depthwise + GELU with c on
    the row band of 8 rows at hw = 32, its depthwise backward in float32
    row bands, W2 and W1 read as stored)."""
    fn, names, launches = GRAD_CALLS[case]
    with torch.enable_grad():
        fn()
    assert fake_card.names() == names
    assert _launches() == launches
    calls = dict(fake_card.calls)
    if "ltd_flash_attention_f32" in calls:
        # q, k, v, out, lse, B, Nq, Nk, heads: a log-sum-exp output
        assert calls["ltd_flash_attention_f32"][4] is not None
        assert calls["ltd_flash_attention_f32"][5:9] == (2, 1024, 1024, 2)
    if "ltd_dwconv_gelu_bwd" in calls:
        # (.., B, hw, C, band rows, bf16 c and h, float32 taps, stream)
        assert calls["ltd_dwconv_gelu_bwd"][8:14] == (
            2, 32, 512, lv.dwconv_gelu_bwd_body(32, F32), 0, 1)
        assert lv.dwconv_gelu_bwd_body(32, F32) == 8
        w_transposed = [a[11] for n, a in fake_card.calls if n == "ltd_ln_gemm_f32"][-2:]
        assert w_transposed == [1, 1]  # da = g W2 and dx = dh W1


@pytest.mark.parametrize("n,route", [(1024, "k4a"), (4096, "k4b"), (400, "plain")])
def test_float32_attention_gradient_takes_the_jax_route(fake_card, n, route):
    """The float32 backward follows `attention_bwd_route` as the bf16 one
    does: K4a's and K4b's gates both reach the float32 kernel's two
    launches (after a forward that writes the log-sum-exp); the plain
    route (400 tokens, XLA's recompute in JAX) differentiates the plain
    math with no backward launch and a forward without lse."""
    assert att.attention_bwd_route(n, n, 64) == route
    q, k, v = _qkv(n, b=1, grad=True)
    with torch.enable_grad():
        att.flash_attention(q, k, v, 2).sum().backward()
    fwd = dict(fake_card.calls)["ltd_flash_attention_f32"]
    if route == "plain":
        assert fake_card.names() == ["ltd_flash_attention_f32"] and fwd[4] is None
        assert _launches() == {"flash_attention_f32": 1}
    else:
        assert fake_card.names()[1:] == ["ltd_flash_attention_bwd_f32_dq",
                                         "ltd_flash_attention_bwd_f32_dkv"]
        assert fwd[4] is not None
        assert _launches() == {"flash_attention_f32": 1, "flash_attention_bwd_f32": 2}


# ------------------------------ train.main on CUDA ------------------------------


def _absent_data(tmp_path, bucket=None):
    paths = [str(tmp_path / f"absent_{i}.npy") for i in range(3)]
    if bucket is None:
        return pc.DataConfig(*paths)
    return pc.DataConfig(*paths, extra_latent_paths=(bucket,),
                         extra_text_emb_paths=(str(tmp_path / "absent_emb.npy"),))


@pytest.mark.parametrize("case", ["20x20 grid", "40x40-latent bucket"])
def test_train_main_takes_float32_past_256_tokens_on_cuda(tmp_path, case):
    """A float32 config of 20 x 20 tokens, or a native 4 x 4 grid with a
    multires bucket of 40 x 40 latents (400 tokens, its size in the .npy
    header), on "cuda": the compute-dtype check passes and the next thing
    `main` does is read the native data, whose files do not exist."""
    bucket = None
    if case.endswith("bucket"):
        bucket = str(tmp_path / "bucket.npy")
        np.save(bucket, np.zeros((2, 4, 40, 40), np.float32))
    cfg = pc.ModelConfig(
        data_config=_absent_data(tmp_path, bucket),
        denoiser_config=pc.DenoiserConfig(image_size=8 if bucket else 40, embed_dim=64,
                                          n_layers=2, noise_embed_dims=64),
        train_config=pc.TrainConfig(compute_dtype="float32", save_model=False,
                                    checkpoint_dir=str(tmp_path / "ckpts")),
        vae_cfg=pc.VaeConfig(block_out_channels=(8, 16), layers_per_block=1))
    ttrain.check_cuda_compute_dtype(cfg)
    with pytest.raises(FileNotFoundError):
        ttrain.main(cfg, device="cuda")


# ------------------------------ a 1024-token float32 block against JAX ------------------------------

# port against JAX: measured 1.8e-7 (output) and 7.8e-7 (the worst
# gradient, norm2.weight) rel-L2 on the CPU; the bounds leave room for the
# summation orders of two frameworks
BLOCK_OUT_REL_L2 = 1e-5
BLOCK_GRAD_REL_L2 = 1e-5


def _interpret_pallas():
    """The JAX attention module's `pl`, with every pallas_call in interpret
    mode (its K3 forward takes no interpret flag)."""
    shim = types.SimpleNamespace(**{k: getattr(jatt.pl, k) for k in dir(jatt.pl)
                                    if not k.startswith("__")})
    shim.pallas_call = functools.partial(jatt.pl.pallas_call, interpret=True)
    return shim


def test_float32_1024_token_block_matches_jax(monkeypatch):
    """One float32 decoder block on a 32 x 32 grid (1024 tokens, embed 64,
    one head, batch 2): the port's block with train.main's CUDA flags
    (fused_layer_vjp, use_pallas: flash attention and K5's route) against
    the JAX block with its Pallas gate open as on the TPU, so that K3, K4a
    (1024 tokens) and K5 run in interpret mode. Output and the gradients
    of sum(out * g) for x, cond and every parameter, by rel-L2."""
    fused_layer, fused_mlp, remat = ttrain.resolve_fused_flags(pc.TrainConfig(), on_cuda=True)
    assert (fused_layer, fused_mlp, remat) == (True, False, False)
    seen = []
    monkeypatch.setattr(jatt, "_pallas_ok", lambda q, k: (
        q.shape[-2] >= 8 and k.shape[-2] >= 8 and q.shape[-1] % 8 == 0))
    monkeypatch.setattr(jatt, "pl", _interpret_pallas())
    real_bwd = jatt._pallas_attention_bwd
    monkeypatch.setattr(jatt, "_pallas_attention_bwd", lambda *a: seen.append("k4a") or real_bwd(
        *a, interpret=True))
    rng = np.random.default_rng(3)
    n = 1024
    x = rng.standard_normal((2, n, 64)).astype(np.float32)
    y = rng.standard_normal((2, 2, 64)).astype(np.float32)
    g = (rng.standard_normal((2, n, 64)) * 0.1).astype(np.float32)
    jblock = JaxDecoderBlock(embed_dim=64, mlp_multiplier=4, dropout_level=0.0,
                             fused_layer_vjp=True, use_pallas=True, dtype=jnp.float32)
    # the same parameter tree as the plain block's (the fused MLP makes the
    # plain one's), which initialises without the interpreted kernels
    plain = JaxDecoderBlock(embed_dim=64, mlp_multiplier=4, dropout_level=0.0,
                            dtype=jnp.float32)
    params = jax.jit(plain.init)(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(y))["params"]

    def f(p, xx, yy):
        out = jblock.apply({"params": p}, xx, yy)
        return jnp.sum(out * g), out

    (_, jout), (jgp, jgx, jgy) = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(y))
    assert seen == ["k4a"]

    def state_dict(tree):
        return {k: torch.from_numpy(v) for k, v in
                convert.decoder_block_state_dict(jax.tree.map(np.asarray, tree)).items()}

    block = blocks.DecoderBlock(64, 4, dtype=F32, fused_layer_vjp=fused_layer,
                                use_pallas=True)
    block.load_state_dict(state_dict(params))
    calls = []
    for mod, name in ((blocks, "fused_mlp_sepconv"), (att, "flash_attention_bwd")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, functools.partial(
            lambda real, name, *a, **kw: calls.append(name) or real(*a, **kw), real, name))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    out = block(xt, yt)
    (out * torch.from_numpy(g)).sum().backward()
    assert sorted(calls) == ["flash_attention_bwd", "fused_mlp_sepconv"]
    errs = {"x": rel_l2(xt.grad.numpy(), np.asarray(jgx)),
            "cond": rel_l2(yt.grad.numpy(), np.asarray(jgy))}
    errs.update({k: rel_l2(dict(block.named_parameters())[k].grad.numpy(), w.numpy())
                 for k, w in state_dict(jgp).items()})
    out_err = rel_l2(out.detach().numpy(), np.asarray(jout))
    print(f"float32 block, 1024 tokens, port vs JAX rel-L2: output {out_err:.3e}, worst "
          f"gradient {max(errs.values()):.3e}; {errs}")
    assert out_err < BLOCK_OUT_REL_L2
    assert max(errs.values()) < BLOCK_GRAD_REL_L2, errs
