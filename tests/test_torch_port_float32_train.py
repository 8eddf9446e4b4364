"""Float32 training at <= 256 tokens, the JAX package's default compute
dtype (`TrainConfig(compute_dtype="float32")`): K2 (the sep-conv decoder
layer) and K6 (the attention pair of the "mlp" and "moe" FFNs) with their
float32 backward bodies (ops/fused_layer_vjp_f32.py).

- (a) The plain versions of the float32 bodies against float32 math
  written another way (F.layer_norm, a grouped conv2d, autograd through
  an explicit softmax attention and through GELU(depthwise)): the
  normalised rows and the transposed product of `ln_gemm`, the pre-GELU
  c of `dwconv_gelu`, `weight_grad`, both attention backwards and the
  depthwise backward with float32 taps.
- (b) The K2 layer's and the K6 pair's backward through the wrappers'
  CPU route (the kernel path's composition, `fused_layer_bwd` and
  `fused_attention_pair_bwd`) in float32 against the JAX kernels in
  interpret mode, at the JAX tests' bounds (atol 1e-3, rtol 1e-2).
- (c) A tiny Denoiser built as `train.main` builds it on CUDA in float32
  (its kernel flags), its loss and every gradient on the JAX draws against
  the JAX float32 train step, for the "sep_conv" and "moe" FFNs.
- (d) The wrappers' float32 dispatch without a card (meta tensors for
  CUDA ones, the library a recorder): each float32 body's entry point and
  its own launch counter, no bf16 one; a whole float32 K2 layer and K6
  pair, forward and backward, launch exactly `K2_LAUNCHES_PER_LAYER` and
  `K6_LAUNCHES_PER_LAYER`.
- `train.main` in float32 on "cuda": a config of at most 256 tokens gets
  past the compute-dtype check (it then fails on the absent data files);
  the refusals past 256 tokens are in tests/test_torch_port_float32_hires.py.
The kernels themselves are held against their plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py's [float32-train-kernels])."""

import math
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from transformer_latent_diffusion_tpu.configs import DenoiserConfig as JaxDenoiserConfig
from transformer_latent_diffusion_tpu.configs import TrainConfig as JaxTrainConfig
from transformer_latent_diffusion_tpu.models import Denoiser as JaxDenoiser
from transformer_latent_diffusion_tpu.ops.fused_attn_vjp import fused_attention_pair_vjp as jk6
from transformer_latent_diffusion_tpu.ops.fused_layer_vjp import fused_layer_vjp as jk2
from transformer_latent_diffusion_tpu.train import train as jtrain
from transformer_latent_diffusion_tpu.utils import init_denoiser_params
from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
from transformer_latent_diffusion_tpu_torch.ops import fused_attn_vjp as k6
from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp_f32 as fb
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.ops import fused_stack_f32 as f32
from transformer_latent_diffusion_tpu_torch.train import train as ttrain

torch.set_num_threads(2)

# the tiny configuration: 16 tokens (4 x 4), embed_dim 64, one head, hidden 256
B, HW, D, H = 2, 4, 64, 1
N, HID = HW * HW, 4 * D
F32 = torch.float32


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _randn(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


# ------------------------------ (a) the plain versions ------------------------------


def test_ln_gemm_float32_rows_and_transposed_product():
    """return_xn gives the float32 LayerNorm rows (no rounding) and the
    product of them; w_transposed multiplies by W (K, N) as stored."""
    x, w = _randn(0, 32, D), _randn(1, 3 * D, D, scale=D ** -0.5)
    scale, shift = 1 + _randn(2, D, scale=0.1), _randn(3, D, scale=0.1)
    out, xn = fs.ln_gemm_plain(x, w, ln=(scale, shift), return_xn=True)
    want = F.layer_norm(x.double(), (D,), scale.double(), shift.double(), 1e-5)
    assert xn.dtype == F32 and out.dtype == F32
    assert _rel_l2(xn, want) < 1e-6
    assert _rel_l2(out, want @ w.double().T) < 1e-6
    dy, wt = _randn(4, 32, HID), _randn(5, HID, D, scale=HID ** -0.5)
    got = fs.ln_gemm_plain(dy, wt, out_dtype=F32, w_transposed=True)
    assert got.dtype == F32 and _rel_l2(got, dy.double() @ wt.double()) < 1e-6


def _depthwise(h, dw, dwb, hw):
    """GELU input c of a (M, C) token grid: a grouped conv2d with taps
    (9, C), tap di*3+dj, zero padding, float64."""
    m, c = h.shape
    img = h.double().reshape(m // (hw * hw), hw, hw, c).permute(0, 3, 1, 2)
    k = dw.double().T.reshape(c, 1, 3, 3)
    out = F.conv2d(img, k, dwb.double(), padding=1, groups=c)
    return out.permute(0, 2, 3, 1).reshape(m, c)


def test_dwconv_gelu_float32_c():
    """return_c with float32 taps: c = depthwise(h) + dwb in float32 and
    the exact GELU of it."""
    h, dw, dwb = _randn(0, B * N, HID), _randn(1, 9, HID, scale=1 / 3), _randn(2, HID, scale=0.1)
    act, c = fs.dwconv_gelu_plain(h, dw, dwb, HW, return_c=True)
    want_c = _depthwise(h, dw, dwb, HW)
    assert act.dtype == F32 and c.dtype == F32
    assert _rel_l2(c, want_c) < 1e-6
    assert _rel_l2(act, F.gelu(want_c)) < 1e-6


def test_weight_grad_float32():
    dy, x = _randn(0, 300, 24), _randn(1, 300, 40)
    got = lv.weight_grad_plain(dy, x)
    assert got.dtype == F32 and _rel_l2(got, dy.double().T @ x.double()) < 1e-6


def _attention_grads(q, k, v, g, heads):
    """(dq, dk, dv) of softmax(q k^T / sqrt(dh)) v per head by autograd,
    float64; q (B, Nq, D), k and v (B, Nk, D), heads merged."""
    q, k, v = (t.double().requires_grad_(True) for t in (q, k, v))

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], heads, -1).transpose(1, 2)

    p = torch.softmax(split(q) @ split(k).transpose(-1, -2) / math.sqrt(D // heads), -1)
    o = (p @ split(v)).transpose(1, 2).reshape(g.shape)
    o.backward(g.double())
    return q.grad, k.grad, v.grad


@pytest.mark.parametrize("heads", [1, 2])
def test_self_attention_bwd_float32(heads):
    qkv, g = _randn(0, B * N, 3 * D), _randn(1, B * N, D, scale=0.1)
    got = lv.self_attention_bwd_plain(qkv, g, heads, N)
    q, k, v = (t.reshape(B, N, D) for t in qkv.split(D, -1))
    want = torch.cat([t.reshape(B * N, D) for t in
                      _attention_grads(q, k, v, g.reshape(B, N, D), heads)], -1)
    assert got.dtype == F32 and _rel_l2(got, want) < 1e-6


@pytest.mark.parametrize("heads", [1, 2])
def test_cross_attention_bwd_float32(heads):
    qc, kv, g = _randn(0, B * N, D), _randn(1, 2 * B, 2 * D), _randn(2, B * N, D, scale=0.1)
    dqc, dkv = lv.cross_attention_bwd_plain(qc, kv, g, heads, N)
    k, v = (t.reshape(B, 2, D) for t in kv.split(D, -1))
    dq, dk, dv = _attention_grads(qc.reshape(B, N, D), k, v, g.reshape(B, N, D), heads)
    assert dqc.dtype == F32 and dkv.dtype == F32
    assert _rel_l2(dqc, dq.reshape(B * N, D)) < 1e-6
    assert _rel_l2(dkv, torch.cat([dk, dv], -1).reshape(2 * B, 2 * D)) < 1e-6


def test_dwconv_gelu_bwd_float32_taps():
    """Float32 taps: dhid float32, unrounded, and the tap, bias and db1
    sums, against autograd through GELU(depthwise(h) + dwb)."""
    h, dw, dwb = _randn(0, B * N, HID), _randn(1, 9, HID, scale=1 / 3), _randn(2, HID, scale=0.1)
    da = _randn(3, B * N, HID, scale=0.1)
    c = _depthwise(h, dw, dwb, HW).float()
    dhid, taps, ddwb, db1 = lv.dwconv_gelu_bwd_plain(da, c, h, dw, HW)
    hh, ww, bb = (t.double().requires_grad_(True) for t in (h, dw, dwb))
    F.gelu(_depthwise(hh, ww, bb, HW)).backward(da.double())
    assert dhid.dtype == F32 and taps.shape == (9, HID)
    assert _rel_l2(dhid, hh.grad) < 1e-6
    assert _rel_l2(taps, ww.grad) < 1e-5
    assert _rel_l2(ddwb, bb.grad) < 1e-5
    assert _rel_l2(db1, hh.grad.sum(0)) < 1e-5


# ------------------------------ (b) K2 and K6 against JAX ------------------------------


def _k2_args(seed):
    """The JAX kernel's 17 inputs in its layouts (projections (in, out),
    taps (3, 3, hidden)), as tests/test_fused_layer_vjp.py draws them."""
    rng = np.random.default_rng(seed)

    def arr(*s):
        return (rng.standard_normal(s) * 0.3).astype(np.float32)

    ones = np.ones(D, np.float32)
    return [arr(B, N, D), arr(B, 2, D), ones, arr(D), arr(D, 3 * D), ones, arr(D),
            arr(D, D), arr(D, 2 * D), ones, arr(D), arr(D, HID), arr(HID),
            arr(3, 3, HID), arr(HID), arr(HID, D), arr(D)]


def _k2_port(args):
    names = ("x", "cond") + lv.PARAM_NAMES
    conv = {"wqkv": np.transpose, "wq": np.transpose, "wkv": np.transpose,
            "w1": np.transpose, "w2": np.transpose, "dw": lambda a: a.reshape(9, HID)}
    return [torch.from_numpy(np.ascontiguousarray(conv.get(n, lambda a: a)(a)))
            for n, a in zip(names, args)]


def test_k2_float32_backward_matches_jax():
    """`fused_layer_bwd` (the backward's composition over the wrappers,
    recompute included) in float32 against the JAX K2's VJP in interpret
    mode: dx, dcond and the 15 parameter gradients, all float32."""
    args = _k2_args(1)
    g = (np.random.default_rng(2).standard_normal((B, N, D)) * 0.1).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jk2(*a, H, HW, True), *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(g))
    x, cond, *params = _k2_port(args)
    dx, dcond, grads = lv.fused_layer_bwd(x, cond, torch.from_numpy(g), params, H, HW)
    got = [dx, dcond, *grads]
    for t in got:
        assert t.dtype == F32
    back = _k2_port([np.asarray(w) for w in want])
    for name, gt, w in zip(("x", "cond") + lv.PARAM_NAMES, got, back):
        np.testing.assert_allclose(gt.numpy(), w.numpy(), atol=1e-3, rtol=1e-2, err_msg=name)


def test_k6_float32_backward_matches_jax():
    """`fused_attention_pair_bwd` in float32 against the JAX K6's VJP in
    interpret mode: dx, dcond and the seven parameter gradients."""
    rng = np.random.default_rng(3)

    def arr(*s, scale=0.3):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    args = [arr(B, N, D), arr(B, 2, D), 1 + arr(D, scale=0.1), arr(D), arr(D, 3 * D),
            1 + arr(D, scale=0.1), arr(D), arr(D, D), arr(D, 2 * D)]
    g = arr(B, N, D, scale=0.1)
    _, vjp = jax.vjp(lambda *a: jk6(*a, H, True), *(jnp.asarray(a) for a in args))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    port = [torch.from_numpy(a.T.copy() if i in (4, 7, 8) else a) for i, a in enumerate(args)]
    got = k6.fused_attention_pair_bwd(*port[:2], torch.from_numpy(g), *port[2:], H)
    for i, (gt, w) in enumerate(zip(got, want)):
        assert gt.dtype == F32
        gt = gt.numpy().T if i in (4, 7, 8) else gt.numpy()
        np.testing.assert_allclose(gt, w, atol=1e-3, rtol=1e-2, err_msg=k6.PARAM_NAMES[i - 2]
                                   if i >= 2 else ("x", "cond")[i])


# ------------------------------ (c) the float32 train step against JAX ------------------------------


def _jax_draws(rng, n, shape, train_cfg):
    """The JAX loss_fn's draws for `rng` (train.py:357-397), as torch."""
    r_beta, r_noise, r_drop, _, _ = jax.random.split(rng, 5)
    nl = jtrain.sample_beta(r_beta, train_cfg.beta_a, train_cfg.beta_b, (n, 1))
    noise = jax.random.normal(r_noise, shape, dtype=jnp.float32)
    keep = jax.random.uniform(r_drop, (n, 1)) >= 0.15
    return {"noise_level": torch.from_numpy(np.array(nl)),
            "noise": torch.from_numpy(np.array(noise)),
            "keep": torch.from_numpy(np.array(keep))}


@pytest.mark.parametrize("mlp_class", ["sep_conv", "moe"])
def test_float32_train_step_matches_jax(mlp_class):
    """A tiny float32 Denoiser built with the kernel flags `train.main`
    sets on CUDA (K2 for "sep_conv", K6 beside the FFN for "moe"; the
    wrappers' CPU route here), the same weights (convert.py), batch and
    JAX draws: the loss to 1e-5 relative and every gradient leaf within
    rel-L2 1e-4 of the JAX package's float32 step."""
    tiny = dict(image_size=8, embed_dim=D, n_layers=2, noise_embed_dims=64,
                mlp_class=mlp_class, n_experts=4)
    jcfg = JaxDenoiserConfig(**tiny)
    jmodel = JaxDenoiser(**asdict(jcfg), fused_layer_vjp=True)
    params = init_denoiser_params(jmodel, jcfg)
    jtc = JaxTrainConfig(moe_aux_weight=0.5)
    rng_np = np.random.default_rng(7)
    x = rng_np.standard_normal((4, 4, 8, 8)).astype(np.float32)
    y = rng_np.standard_normal((4, 768)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    jloss, jgrads = jax.jit(jax.value_and_grad(jtrain.build_loss_fn(jmodel, jtc, 8.0)))(
        params, jnp.asarray(x), jnp.asarray(y), rng)

    tc = pc.TrainConfig(compute_dtype="float32", moe_aux_weight=0.5)
    fused_layer, fused_mlp, fused_attn = ttrain.resolve_fused_flags(tc, on_cuda=True)
    model = Denoiser.from_config(pc.DenoiserConfig(**asdict(jcfg)),
                                 dtype=pc.resolve_dtype(tc.compute_dtype),
                                 fused_layer_vjp=fused_layer, use_pallas=True,
                                 fused_mlp_vjp=fused_mlp, fused_attn_vjp=fused_attn)
    sd = convert.denoiser_state_dict(jax.tree.map(np.asarray, params), jcfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    loss_fn = ttrain.build_loss_fn(model, tc, 8.0)
    loss = loss_fn.loss_from_draws(model, torch.from_numpy(x), torch.from_numpy(y),
                                   **_jax_draws(rng, 4, x.shape, jtc))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = convert.denoiser_state_dict(jax.tree.map(np.asarray, jgrads), jcfg)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) <= set(want)
    for name, gr in grads.items():
        assert gr.dtype == F32
        assert _rel_l2(gr.numpy(), want[name]) < 1e-4, name


# ------------------------------ (d) the float32 dispatch, rehearsed ------------------------------


class _RecordingLib:
    """The kernels' library: records the entry points called, launches
    nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name == "ltd_ln_gemm_scratch_rows":  # a size query, no launch
            return lambda *a: 0

        def call(*args):
            self.calls.append(name)
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors pass for CUDA ones: the wrappers' checks, allocation,
    plans and dispatch run, and the library records the entry points."""
    lib = _RecordingLib()
    meta = torch.device("meta")
    for mod in (fs, lv):
        monkeypatch.setattr(mod, "_on_cuda", lambda name, *ts: meta)
        monkeypatch.setattr(mod, "_stream", lambda dev: None)
        monkeypatch.setattr(mod, "_ptr", lambda t: None)
    for mod in (fs, f32, lv, fb):
        monkeypatch.setattr(mod, "load_library", lambda: lib)
    monkeypatch.setattr(fs, "tma_operand", lambda t: True)
    monkeypatch.setattr(k6, "_require_cuda", lambda name, x, cond: None)
    monkeypatch.setattr(lv, "_zeroed_counters",
                        lambda dev, n: torch.zeros(n, dtype=torch.int32, device=dev))

    def plan_on(m, n, k, dev, tile=lv.WG_TILE, stage_rows=lv.WG_STAGE_ROWS):
        plan = lv.weight_grad_plan(m, n, k, 132, tile, stage_rows)
        return plan, torch.empty(len(plan.table()), dtype=torch.int32, device=dev)
    monkeypatch.setattr(lv, "_plan_on", plan_on)
    counted = (fs, f32, lv, fb)
    for mod in counted:
        mod.reset_launch_counts()
    yield lib
    for mod in counted:
        mod.reset_launch_counts()


def _meta(*shape, dtype=F32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _launches():
    return {k: v for mod in (fs, f32, lv, fb) for k, v in mod.LAUNCHES.items() if v}


def _modes():
    return {k: v for k, v in f32.MODE_LAUNCHES.items() if v}


M = B * N
BODY_CALLS = {
    "ln_gemm return_xn": (lambda: fs.ln_gemm(_meta(M, D), _meta(3 * D, D), return_xn=True,
                                             ln=(_meta(D), _meta(D))),
                          "ltd_ln_gemm_f32", "ln_gemm_f32"),
    "ln_gemm w_transposed": (lambda: fs.ln_gemm(_meta(M, HID), _meta(HID, D), out_dtype=F32,
                                                w_transposed=True),
                             "ltd_ln_gemm_f32", "ln_gemm_f32"),
    "dwconv_gelu return_c": (lambda: fs.dwconv_gelu(_meta(M, HID), _meta(9, HID), _meta(HID),
                                                    HW, return_c=True, c_dtype=F32),
                             "ltd_dwconv_gelu", "dwconv_gelu_f32"),
    "weight_grad": (lambda: lv.weight_grad(_meta(M, 3 * D), _meta(M, D)),
                    "ltd_weight_grad_f32", "weight_grad_f32"),
    "self_attention_bwd": (lambda: lv.self_attention_bwd(_meta(M, 3 * D), _meta(M, D), H, N),
                           ("ltd_self_attention_bwd_f32_dq", "ltd_self_attention_bwd_f32_dkv"),
                           "self_attention_bwd_f32"),
    "cross_attention_bwd": (lambda: lv.cross_attention_bwd(_meta(M, D), _meta(2 * B, 2 * D),
                                                           _meta(M, D), H, N),
                            "ltd_cross_attention_bwd_f32", "cross_attention_bwd_f32"),
    "dwconv_gelu_bwd": (lambda: lv.dwconv_gelu_bwd(_meta(M, HID), _meta(M, HID),
                                                   _meta(M, HID), _meta(9, HID), HW),
                        "ltd_dwconv_gelu_bwd", "dwconv_gelu_bwd_f32"),
}


@pytest.mark.parametrize("case", sorted(BODY_CALLS))
def test_float32_operands_take_the_float32_body(fake_card, case):
    """Each float32 call of the backward's wrappers launches its float32
    entry points once each (self_attention_bwd's body is two kernels, dq
    then dk/dv) and steps that body's counter alone, once a launch; every
    output is float32."""
    call, entries, counter = BODY_CALLS[case]
    entries = [entries] if isinstance(entries, str) else list(entries)
    out = call()
    assert fake_card.calls == entries
    assert _launches() == {counter: len(entries)}
    mode = case.split()[1:]  # a training mode of a forward body: its own count too
    assert _modes() == ({f"{counter} {mode[0]}": 1} if mode else {})
    for t in out if isinstance(out, tuple) else (out,):
        assert t.dtype == F32


BF16 = torch.bfloat16
# the two wrappers whose float32 mode shares the bf16 body's entry point
# or template: bf16 operands keep the bf16 instance and count
BF16_CALLS = {
    "cross_attention_bwd": (lambda: lv.cross_attention_bwd(_meta(M, D, dtype=BF16),
                                                           _meta(2 * B, 2 * D, dtype=BF16),
                                                           _meta(M, D), H, N),
                            "ltd_cross_attention_bwd", "cross_attention_bwd", BF16),
    "dwconv_gelu_bwd": (lambda: lv.dwconv_gelu_bwd(_meta(M, HID), _meta(M, HID, dtype=BF16),
                                                   _meta(M, HID, dtype=BF16),
                                                   _meta(9, HID, dtype=BF16), HW),
                        "ltd_dwconv_gelu_bwd", "dwconv_gelu_bwd", BF16),
}


@pytest.mark.parametrize("case", sorted(BF16_CALLS))
def test_bf16_operands_keep_the_bf16_body(fake_card, case):
    """bf16 operands of a wrapper that also takes float32 ones launch the
    bf16 instance once and step the bf16 counter alone."""
    call, entry, counter, dtype = BF16_CALLS[case]
    out = call()
    assert fake_card.calls == [entry]
    assert _launches() == {counter: 1}
    assert out[0].dtype == dtype


def _meta_layer_params():
    shapes = [(D,), (D,), (3 * D, D), (D,), (D,), (D, D), (2 * D, D), (D,), (D,),
              (HID, D), (HID,), (9, HID), (HID,), (D, HID), (D,)]
    return [_meta(*s) for s in shapes]


def test_float32_k2_layer_launches_exactly(fake_card):
    """One float32 K2 layer, forward and backward (the recompute included),
    launches `fb.K2_LAUNCHES_PER_LAYER`: float32 bodies, colsum and
    layernorm_bwd, no bf16 kernel; `fb.K2_MODE_LAUNCHES_PER_LAYER` of them
    in the forward bodies' training modes."""
    params = _meta_layer_params()
    out = lv.fused_layer_fwd(_meta(B, N, D), _meta(B, 2, D), params, H, HW)
    dx, dcond, grads = lv.fused_layer_bwd(_meta(B, N, D), _meta(B, 2, D), _meta(B, N, D),
                                          params, H, HW)
    assert _launches() == fb.K2_LAUNCHES_PER_LAYER
    assert _modes() == fb.K2_MODE_LAUNCHES_PER_LAYER
    assert all(t.dtype == F32 for t in (out, dx, dcond, *grads))
    assert "ltd_ln_gemm" not in fake_card.calls and "ltd_weight_grad" not in fake_card.calls


def test_float32_k6_pair_launches_exactly(fake_card):
    """One float32 K6 pair, forward and backward, launches
    `fb.K6_LAUNCHES_PER_LAYER` (`fb.K6_MODE_LAUNCHES_PER_LAYER` of them in
    the training modes)."""
    params = _meta_layer_params()[:7]
    k6.fused_attention_pair_fwd(_meta(B, N, D), _meta(B, 2, D), *params, H)
    grads = k6.fused_attention_pair_bwd(_meta(B, N, D), _meta(B, 2, D), _meta(B, N, D),
                                        *params, H)
    assert _launches() == fb.K6_LAUNCHES_PER_LAYER
    assert _modes() == fb.K6_MODE_LAUNCHES_PER_LAYER
    assert all(t.dtype == F32 for t in grads)


# ------------------------------ train.main's check on CUDA ------------------------------


def test_train_main_takes_float32_at_256_tokens_on_cuda(tmp_path):
    """A float32 config of 16 x 16 tokens on "cuda" gets past the
    compute-dtype check: the next thing `main` does is read the data,
    whose files do not exist."""
    cfg = pc.ModelConfig(
        data_config=pc.DataConfig(*(str(tmp_path / f"absent_{i}.npy") for i in range(3))),
        denoiser_config=pc.DenoiserConfig(image_size=32, embed_dim=64, n_layers=2,
                                          noise_embed_dims=64),
        train_config=pc.TrainConfig(compute_dtype="float32", save_model=False,
                                    checkpoint_dir=str(tmp_path / "ckpts")))
    ttrain.check_cuda_compute_dtype(cfg)
    with pytest.raises(FileNotFoundError):
        ttrain.main(cfg, device="cuda")
