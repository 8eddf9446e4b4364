"""Hi-res training in the port against the JAX package: the attention
backward (K4) and its route, the sep-conv MLP's backward (K5), the fused
decoder block beyond the K2 gate, a tiny hi-res model's loss and every
gradient (with and without remat), multires buckets with the resized
positional table and schedule_shift="auto", and `finetune_highres`.

On the CPU the port's wrappers run their kernels' plain versions; the JAX
package runs its Pallas kernels K4a, K4b and K5 in interpret mode and its
attention's plain reference `_xla_attention` (its `_pallas_ok` is false
off the TPU), as its own tests do. The CUDA kernels are checked against the
plain versions on the card (tests/test_torch_port_cuda.py, and
chip_smoke.py)."""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.configs import DenoiserConfig as JaxDenoiserConfig
from transformer_latent_diffusion_tpu.configs import TrainConfig as JaxTrainConfig
from transformer_latent_diffusion_tpu.models import Denoiser as JaxDenoiser
from transformer_latent_diffusion_tpu.models.blocks import DecoderBlock as JaxDecoderBlock
from transformer_latent_diffusion_tpu.models.torch_compat import (
    convert_torch_denoiser_state_dict,
)
from transformer_latent_diffusion_tpu.ops import attention as jatt
from transformer_latent_diffusion_tpu.ops.fused_mlp_vjp import _pallas_bwd
from transformer_latent_diffusion_tpu.train import train as jtrain
from transformer_latent_diffusion_tpu.utils import init_denoiser_params
from transformer_latent_diffusion_tpu.utils.goldens import rel_l2
from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models import blocks
from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
from transformer_latent_diffusion_tpu_torch.ops import attention as att
from transformer_latent_diffusion_tpu_torch.ops import fused_layer_vjp as lv
from transformer_latent_diffusion_tpu_torch.ops import fused_mlp_vjp as fm
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.train import train as ttrain
from transformer_latent_diffusion_tpu_torch.train.highres import (
    finetune_highres,
    upsample_denoiser_params,
)

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# a tiny hi-res model: an 18 x 18 token grid (324 tokens, beyond K2's gate)
HIRES = dict(image_size=36, patch_size=2, embed_dim=64, n_layers=2,
             noise_embed_dims=64)
TINY = dict(image_size=8, embed_dim=64, n_layers=2, noise_embed_dims=64)


def _np(t):
    return t.detach().float().numpy()


# ------------------------------ K4: the attention backward ------------------------------


@pytest.mark.parametrize("variant", ["k4a", "k4b"])
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_bwd_plain_matches_jax_kernels(variant, n, dtype):
    """`attention_bwd_plain` against K4a (`_pallas_attention_bwd`) and K4b
    (`_pallas_attention_bwd_tiled`, q_block 32) in interpret mode, 2 images
    x 2 heads of 64: float32 rel-L2 < 1e-5 per output (summation order
    only); bf16 < 1e-2 (the same roundings of ds and p, which one
    summation-order difference can flip by one bf16 step)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(n)
    q, k, v, g = (rng.standard_normal((2, 2, n, 64)).astype(np.float32) for _ in range(4))
    ja = [jnp.asarray(a, jdt) for a in (q, k, v, g)]
    if variant == "k4a":
        want = jatt._pallas_attention_bwd(*ja, interpret=True)
    else:
        want = jatt._pallas_attention_bwd_tiled(*ja, q_block=32, interpret=True)
    got = att.attention_bwd_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v, g)))
    bound = 1e-5 if dtype == "float32" else 1e-2
    for name, u, w in zip(("dq", "dk", "dv"), got, want):
        assert u.dtype == tdt
        assert rel_l2(_np(u), np.asarray(w, np.float32)) < bound, name


def _jax_bwd_route(monkeypatch, n):
    """Which backward the JAX package's `_attention_bwd` takes for n
    tokens, with its Pallas gate open as on the TPU."""
    seen = []
    monkeypatch.setattr(jatt, "_pallas_ok", lambda q, k: (
        q.shape[-2] >= 8 and k.shape[-2] >= 8 and q.shape[-1] % 8 == 0))
    monkeypatch.setattr(jatt, "_pallas_attention_bwd",
                        lambda *a, **kw: seen.append("k4a"))
    monkeypatch.setattr(jatt, "_pallas_attention_bwd_tiled",
                        lambda *a, **kw: seen.append("k4b"))
    monkeypatch.setattr(jatt, "_chunked_attention_bwd",
                        lambda *a, **kw: seen.append("plain"))
    monkeypatch.setattr(jatt, "_xla_attention",
                        lambda q, k, v: seen.append("plain") or q)
    q = jnp.zeros((1, 1, n, 64), jnp.bfloat16)
    jatt._attention_bwd((q, q, q), q)
    return seen[0]


@pytest.mark.parametrize("n", [256, 400, 512, 520, 1024, 2048, 2560, 4096, 8192, 8704])
def test_attention_bwd_route_follows_jax_gates(monkeypatch, n):
    """`attention_bwd_route` names the backward `_attention_bwd` takes:
    K4a for 512 <= N <= 2048 with N % 128 == 0, K4b for N % 512 == 0 up to
    8192, XLA's recompute ("plain" in the port) otherwise."""
    assert att.attention_bwd_route(n, n, 64) == _jax_bwd_route(monkeypatch, n)


def test_flash_attention_gradient_takes_the_route(monkeypatch):
    """`flash_attention` is differentiable: on CPU tensors with the "k4a"
    route its backward is `flash_attention_bwd` (the plain version here),
    which equals torch autograd through `attention_plain` in float32; the
    "plain" route differentiates `attention_plain` itself. No launches."""
    att.reset_launch_counts()
    calls = []
    real = att.flash_attention_bwd
    monkeypatch.setattr(att, "flash_attention_bwd",
                        lambda *a, **kw: calls.append(a[0].shape[1]) or real(*a, **kw))
    for n in (512, 400):
        q, k, v = (torch.randn(2, n, 128, dtype=torch.float64).float().requires_grad_(True)
                   for _ in range(3))
        g = torch.randn(2, n, 128)
        got = torch.autograd.grad(att.flash_attention(q, k, v, 2), (q, k, v), g)
        want = torch.autograd.grad(att._mha_plain(q, k, v, 2), (q, k, v), g)
        for u, w in zip(got, want):
            assert rel_l2(_np(u), _np(w)) < 1e-5
    assert calls == [512]
    assert all(v == 0 for v in att.LAUNCHES.values())


# ------------------------------ K5: the sep-conv MLP's backward ------------------------------


def _mlp_inputs(hw, d=64, hidden=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, hw * hw, d)).astype(np.float32),
            (rng.standard_normal((d, hidden)) * d ** -0.5).astype(np.float32),
            (rng.standard_normal(hidden) * 0.1).astype(np.float32),
            (rng.standard_normal((9, hidden)) / 3).astype(np.float32),
            (rng.standard_normal(hidden) * 0.1).astype(np.float32),
            (rng.standard_normal((hidden, d)) * hidden ** -0.5).astype(np.float32),
            (rng.standard_normal(d) * 0.1).astype(np.float32))


def _port_mlp_args(x, w1, b1, dw, dwb, w2, b2, dtype, device="cpu"):
    """The JAX layouts in the port's: (out, in) products, float32 biases."""
    def t(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    return (t(x), t(w1.T), t(b1, torch.float32), t(dw), t(dwb, torch.float32),
            t(w2.T), t(b2, torch.float32))


@pytest.mark.parametrize("hw", [4, 8])
def test_fused_mlp_sepconv_bwd_plain_matches_jax_kernel(hw):
    """`fused_mlp_sepconv_bwd_plain` against K5's `_pallas_bwd` in interpret
    mode, d 64, hidden 256, float32: all 7 outputs (dx, dW1, db1, the taps,
    ddwb, dW2, db2) within the bounds of test_fused_mlp_sepconv_matches_jax_
    kernel, atol 1e-4 / rtol 1e-3 (summation order and the TPU kernel's erf
    polynomial)."""
    args = _mlp_inputs(hw)
    x, w1, b1, dw, dwb, w2, _ = args
    g = np.random.default_rng(hw).standard_normal(x.shape).astype(np.float32)
    want = _pallas_bwd(*(jnp.asarray(a) for a in (x, g, w1, b1, dw, dwb, w2)), hw, True)
    px, pw1, pb1, pdw, pdwb, pw2, _ = _port_mlp_args(*args, torch.float32)
    got = fm.fused_mlp_sepconv_bwd_plain(px, torch.from_numpy(g), pw1, pb1, pdw, pdwb,
                                         pw2, hw)
    # the port's (out, in) weight gradients are the JAX ones transposed
    got = [_np(t) for t in got]
    got[1], got[5] = got[1].T, got[5].T
    for name, u, w in zip(("dx", "dw1", "db1", "ddw", "ddwb", "dw2", "db2"), got, want):
        np.testing.assert_allclose(u, np.asarray(w).reshape(u.shape), atol=1e-4,
                                   rtol=1e-3, err_msg=name)


def test_fused_mlp_sepconv_gradient_is_its_backward():
    """`fused_mlp_sepconv` with a gradient asked for (FusedMLPFunction) on
    CPU tensors: its gradients are `fused_mlp_sepconv_bwd_plain`'s, in each
    input's dtype, and equal torch autograd through the plain forward
    (float32, rel-L2 < 1e-5). No launches."""
    fm.reset_launch_counts()
    args = [t.requires_grad_(True) for t in _port_mlp_args(*_mlp_inputs(4), torch.float32)]
    g = torch.randn(args[0].shape)
    got = torch.autograd.grad(fm.fused_mlp_sepconv(*args, 4), args, g)
    want = torch.autograd.grad(fm.fused_mlp_sepconv_plain(*args, 4), args, g)
    for u, w, a in zip(got, want, args):
        assert u.dtype == a.dtype and u.shape == a.shape
        assert rel_l2(_np(u), _np(w)) < 1e-5
    assert all(v == 0 for v in fm.LAUNCHES.values())


@pytest.mark.parametrize("hw,band", [(16, 0), (17, 0), (18, 8), (28, 8), (29, 8), (32, 8),
                                     (88, 2), (89, 1), (118, 1), (119, None)])
def test_dwconv_gelu_bwd_body_holds_its_slabs(hw, band):
    """The backward depthwise kernel's gate is what a block's 227 KB holds:
    a two-stage ring of float32 dc and h slabs of 32 channels and one c
    slab. The whole grid up to hw 17, then bands of the most rows up to 8
    that fit, with a one-row halo (the 512 px MLP's hw = 32 takes bands of
    8), down to one row at hw 118; beyond that it raises."""
    if band is None:
        with pytest.raises(ValueError, match="shared memory"):
            lv.dwconv_gelu_bwd_body(hw)
        return
    assert lv.dwconv_gelu_bwd_body(hw) == band
    rows = hw if band == 0 else band
    assert lv.dwconv_gelu_bwd_smem(rows, hw, 4) <= fs.SMEM_PER_BLOCK
    if band:  # the most rows that fit
        assert band == lv.DWB_BAND_ROWS or lv.dwconv_gelu_bwd_smem(band + 1, hw, 4) > fs.SMEM_PER_BLOCK
    # two float32 slabs of each of dc and h, one of c
    assert lv.dwconv_gelu_bwd_smem(rows, hw, 4) >= 5 * (rows + 2) * (hw + 2) * lv.DWB_CHUNK * 4


@pytest.mark.parametrize("hw,band", [(16, 0), (20, 0), (21, 8), (32, 8), (64, 5), (170, 1),
                                     (171, None)])
def test_dwconv_gelu_bwd_body_bf16_holds_its_slabs(hw, band):
    """With bf16 c and h (S2's bf16res) the slabs of c and h are half as
    large: the whole grid up to hw 20, then bands, down to one row at hw
    170."""
    if band is None:
        with pytest.raises(ValueError, match="shared memory"):
            lv.dwconv_gelu_bwd_body(hw, torch.bfloat16)
        return
    assert lv.dwconv_gelu_bwd_body(hw, torch.bfloat16) == band
    rows = hw if band == 0 else band
    assert lv.dwconv_gelu_bwd_smem(rows, hw, 2) <= fs.SMEM_PER_BLOCK
    if band:
        assert band == lv.DWB_BAND_ROWS or lv.dwconv_gelu_bwd_smem(band + 1, hw, 2) > fs.SMEM_PER_BLOCK


# ------------------------------ the decoder block beyond K2's gate ------------------------------


def _block_state_dict(params):
    """A JAX DecoderBlock's params (or gradients) as the port block's
    state_dict tensors."""
    return {k: torch.from_numpy(v) for k, v in
            convert.decoder_block_state_dict(jax.tree.map(np.asarray, params)).items()}


def _jax_block_grads(params, x, y, g, dtype):
    """The JAX block (fused_layer_vjp=True) in `dtype`: output, and the
    gradients of sum(out * g) for x, y and the block's params."""
    block = JaxDecoderBlock(embed_dim=64, mlp_multiplier=4, dropout_level=0.0,
                            fused_layer_vjp=True, dtype=dtype)

    def f(p, xx, yy):
        out = block.apply({"params": p}, xx, yy)
        return jnp.sum(out.astype(jnp.float32) * g), out

    # eager, op by op: each operation rounds to bf16 where its dtype says
    # (under jit, XLA's CPU fusions keep some of those intermediates in
    # float32, which moves the output by ~0.003 rel-L2)
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x, dtype), jnp.asarray(y, dtype))
    return np.asarray(out, np.float32), grads


def _port_block_grads(params, x, y, g, dtype):
    block = blocks.DecoderBlock(64, 4, dtype=dtype, fused_layer_vjp=True)
    block.load_state_dict(_block_state_dict(params))
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    yt = torch.from_numpy(y).to(dtype).requires_grad_(True)
    out = block(xt, yt)
    (out.float() * torch.from_numpy(g)).sum().backward()
    grads = {n: p.grad for n, p in block.named_parameters()}
    return _np(out), xt.grad, yt.grad, grads


def _block_case(n=324, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n, 64)).astype(np.float32)
    y = rng.standard_normal((batch, 2, 64)).astype(np.float32)
    g = (rng.standard_normal((batch, n, 64)) * 0.1).astype(np.float32)
    block = JaxDecoderBlock(embed_dim=64, mlp_multiplier=4, dropout_level=0.0,
                            fused_layer_vjp=True)
    params = block.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(y))["params"]
    return params, x, y, g


def test_fused_block_beyond_k2_takes_k5(monkeypatch):
    """A DecoderBlock(fused_layer_vjp=True) on 324 tokens (18 x 18, beyond
    K2's 256) runs its MLP through K5's route, `fused_mlp_sepconv`, as the
    JAX block's `want_mlp` does, though built with fused_mlp_vjp=False
    (the default); the plain modules ran there before."""
    calls = []
    real = blocks.fused_mlp_sepconv
    monkeypatch.setattr(blocks, "fused_mlp_sepconv", lambda *a: calls.append(a[-1]) or real(*a))
    block = blocks.DecoderBlock(64, 4, dtype=torch.bfloat16, fused_layer_vjp=True)
    out = block(torch.randn(1, 324, 64), torch.randn(1, 2, 64))
    out.float().sum().backward()
    assert calls == [18]
    assert block.mlp.mlp[0].weight.grad is not None


def test_fused_block_beyond_k2_matches_jax():
    """The same bf16 block on the JAX block's weights (K5 in interpret
    mode there), by rel-L2 against the JAX block: the output below 0.0015,
    the MLP branch's gradients (mlp.*, norm3.*) below 0.003, every other
    gradient (x, cond, the attention halves' weights) below 0.01.

    Measured on the CPU before the repair (the plain modules, which round
    the hidden state to bf16): output 0.0032, MLP-branch gradients up to
    0.0059 (mlp.mlp.0.weight), the others up to 0.0062 (x). After it (K5's
    route: float32 h and c, only the GELU output rounded): output 0.00051,
    MLP-branch gradients up to 0.0012, the others up to 0.0062
    (norm2.bias). The first two bounds lie between the two trees; the
    third covers the attention halves, which neither tree changes (torch
    and JAX autograd round the bf16 attention's products at other
    points)."""
    params, x, y, g = _block_case()
    jout, (jgp, jgx, jgy) = _jax_block_grads(params, x, y, g, jnp.bfloat16)
    out, gx, gy, grads = _port_block_grads(params, x, y, g, torch.bfloat16)
    want = _block_state_dict(jgp)
    errs = {"x": rel_l2(_np(gx), np.asarray(jgx, np.float32)),
            "cond": rel_l2(_np(gy), np.asarray(jgy, np.float32))}
    errs.update({k: rel_l2(_np(grads[k]), _np(w)) for k, w in want.items()})
    mlp = {k: v for k, v in errs.items() if k.startswith(("mlp.", "norm3."))}
    rest = {k: v for k, v in errs.items() if k not in mlp}
    out_err = rel_l2(out, jout)
    print(f"bf16 block, 324 tokens, port vs JAX rel-L2: output {out_err:.5f}, MLP "
          f"branch {max(mlp.values()):.5f}, others {max(rest.values()):.5f}; {errs}")
    assert out_err < 0.0015
    assert max(mlp.values()) < 0.003, mlp
    assert max(rest.values()) < 0.01, rest


# ------------------------------ the slice: a tiny hi-res model ------------------------------


def _jax_draws(rng, n, shape, train_cfg):
    r_beta, r_noise, r_drop, _, _ = jax.random.split(rng, 5)
    nl = jtrain.sample_beta(r_beta, train_cfg.beta_a, train_cfg.beta_b, (n, 1))
    noise = jax.random.normal(r_noise, shape, dtype=jnp.float32)
    keep = jax.random.uniform(r_drop, (n, 1)) >= 0.15
    return {"noise_level": torch.from_numpy(np.array(nl)),
            "noise": torch.from_numpy(np.array(noise)),
            "keep": torch.from_numpy(np.array(keep))}


def _port_model(jcfg, params, **flags):
    model = Denoiser.from_config(pc.DenoiserConfig(**asdict(jcfg)), **flags)
    sd = convert.denoiser_state_dict(jax.tree.map(np.asarray, params), jcfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model


def _loss_and_grads(jcfg, params, x, y, jtc, tc, rng, jax_kw, port_kw):
    """(loss, grads) of the JAX and the port's loss on the same batch, the
    JAX draws and the same weights: JAX as a params tree, the port's
    converted to one."""
    jmodel = JaxDenoiser(**asdict(jcfg), **jax_kw)
    jloss, jgrads = jax.jit(jax.value_and_grad(jtrain.build_loss_fn(jmodel, jtc, 8.0)))(
        params, jnp.asarray(x), jnp.asarray(y), rng)
    model = _port_model(jcfg, params, **port_kw)
    loss = ttrain.build_loss_fn(model, tc, 8.0).loss_from_draws(
        model, torch.from_numpy(x), torch.from_numpy(y),
        **_jax_draws(rng, x.shape[0], x.shape, jtc))
    loss.backward()
    grads = convert_torch_denoiser_state_dict(
        {n: p.grad for n, p in model.named_parameters()}, jcfg)
    return (float(loss.detach()), grads), (float(jloss), jgrads)


def _assert_grads_close(got, want, bound):
    got = jax.tree_util.tree_leaves_with_path(got)
    want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(got) == len(want)
    for path, gr in got:
        assert rel_l2(gr, want[path]) < bound, jax.tree_util.keystr(path)


@pytest.fixture(scope="module")
def hires():
    jcfg = JaxDenoiserConfig(**HIRES)
    params = init_denoiser_params(JaxDenoiser(**asdict(jcfg)), jcfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 4, 36, 36)).astype(np.float32)
    y = rng.standard_normal((2, 768)).astype(np.float32)
    return jcfg, params, x, y


@pytest.mark.parametrize("remat", [False, True])
def test_hires_loss_and_grads_match_jax(hires, remat):
    """A tiny hi-res Denoiser (324 tokens, 2 layers, d 64) with
    fused_layer_vjp=True and use_pallas=True on both sides (the port's
    attention through FlashAttentionFunction, its MLP through K5's route;
    JAX's K5 in interpret mode), with and without remat, on the JAX draws:
    the loss to 1e-5 relative and every gradient leaf to rel-L2 1e-4
    (float32; summation order and the TPU kernel's erf polynomial), as
    test_loss_and_grads_match_jax_on_jax_draws."""
    jcfg, params, x, y = hires
    kw = dict(fused_layer_vjp=True, use_pallas=True, remat=remat)
    (loss, grads), (jloss, jgrads) = _loss_and_grads(
        jcfg, params, x, y, JaxTrainConfig(), pc.TrainConfig(), jax.random.PRNGKey(5),
        kw, kw)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_grads_close(grads, jgrads, 1e-4)


def test_hires_remat_equals_no_remat(hires):
    """The port's remat=True (torch.utils.checkpoint per block) recomputes
    the same float32 forward: loss and every gradient equal to remat=False
    within 1e-6 relative (the recompute repeats each operation on the same
    inputs; the bound only allows for a different thread split)."""
    jcfg, params, x, y = hires
    draws = _jax_draws(jax.random.PRNGKey(5), 2, x.shape, JaxTrainConfig())
    out = []
    for remat in (False, True):
        model = _port_model(jcfg, params, fused_layer_vjp=True, use_pallas=True,
                            remat=remat)
        loss = ttrain.build_loss_fn(model, pc.TrainConfig(), 8.0).loss_from_draws(
            model, torch.from_numpy(x), torch.from_numpy(y), **draws)
        loss.backward()
        out.append((float(loss.detach()), {n: p.grad.clone() for n, p in
                                           model.named_parameters()}))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    for k, v in out[0][1].items():
        torch.testing.assert_close(out[1][1][k], v, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("size", [8, 16], ids=["native", "2x"])
def test_multires_loss_and_pos_grad_match_jax(size):
    """A batch of the native 8 x 8 latent and one of a 2x bucket (16 x 16,
    the table bilinear-resized inside the loss) with
    schedule_shift="auto" (no shift on the native bucket, 2.0 on the 2x
    one), on the plain model: the loss and every gradient, the positional
    table's included, against the JAX package's build_loss_fn on its
    draws, float32 rel 1e-5 / rel-L2 1e-4 (as
    test_loss_and_grads_match_jax_on_jax_draws)."""
    jcfg = JaxDenoiserConfig(**TINY)
    params = init_denoiser_params(JaxDenoiser(**asdict(jcfg)), jcfg)
    rng = np.random.default_rng(size)
    x = rng.standard_normal((4, 4, size, size)).astype(np.float32)
    y = rng.standard_normal((4, 768)).astype(np.float32)
    (loss, grads), (jloss, jgrads) = _loss_and_grads(
        jcfg, params, x, y, JaxTrainConfig(schedule_shift="auto"),
        pc.TrainConfig(schedule_shift="auto"), jax.random.PRNGKey(2), {}, {})
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_grads_close(grads, jgrads, 1e-4)
    pos = grads["denoiser_trans_block"]["pos_embed"]
    assert np.abs(pos).max() > 0  # every row of the table trains on the 2x grid too
    lf = ttrain.build_loss_fn(Denoiser.from_config(pc.DenoiserConfig(**TINY)),
                              pc.TrainConfig(schedule_shift="auto"), 8.0)
    assert lf._resolve_shift(torch.zeros(1, 4, size, size)) == (None if size == 8 else 2.0)


# ------------------------------ train.main: buckets and the fine-tune ------------------------------


def _write(tmp_path, name, n, size, seed):
    rng = np.random.default_rng(seed)
    lat, emb = str(tmp_path / f"{name}_lat.npy"), str(tmp_path / f"{name}_emb.npy")
    np.save(lat, rng.standard_normal((n, 4, size, size)).astype(np.float32))
    np.save(emb, rng.standard_normal((n, 768)).astype(np.float32))
    return lat, emb


def _model_config(tmp_path, image_size, n=8, **train_kw):
    lat, emb = _write(tmp_path, f"d{image_size}", n, image_size, image_size)
    val = str(tmp_path / "val.npy")
    np.save(val, np.random.default_rng(0).standard_normal((8, 768)).astype(np.float32))
    kw = dict(n_epoch=1, batch_size=4, save_model=False, save_and_eval_every_iters=10 ** 9,
              checkpoint_dir=str(tmp_path / "ckpts"), fused_layer_vjp=True, lr=1e-3)
    kw.update(train_kw)
    return pc.ModelConfig(
        data_config=pc.DataConfig(lat, emb, val),
        denoiser_config=pc.DenoiserConfig(**{**TINY, "image_size": image_size}),
        train_config=pc.TrainConfig(**kw),
        vae_cfg=pc.VaeConfig(block_out_channels=(8, 16), layers_per_block=1))


def test_multires_buckets_interleave_and_validate(tmp_path, monkeypatch):
    """train.main with a 2x bucket: whole batches alternate between the
    buckets (native 8 x 8 first), both train, and the validation loss is
    kept per bucket (`val_losses_by_size`), the native one also as
    `val_losses`."""
    cfg = _model_config(tmp_path, 8, n=12, val_holdout=4, save_and_eval_every_iters=4)
    lat, emb = _write(tmp_path, "x2", 12, 16, 3)
    cfg.data_config.extra_latent_paths = (lat,)
    cfg.data_config.extra_text_emb_paths = (emb,)
    sizes = []
    real = ttrain.train_step
    monkeypatch.setattr(ttrain, "train_step", lambda state, g, tc, x, *a: (
        sizes.append(x.shape[-1]) or real(state, g, tc, x, *a)))
    r = ttrain.main(cfg, device="cpu")
    assert sizes == [8, 16, 8, 16]  # 8 examples per bucket / batch 4, one epoch
    assert r["global_step"] == 4 and all(np.isfinite(r["losses"]))
    assert sorted(r["val_losses_by_size"]) == [8, 16]
    assert [s for s, _ in r["val_losses"]] == [0]
    assert r["val_losses"] == r["val_losses_by_size"][8]


def test_finetune_highres_warm_starts_trains_and_resumes(tmp_path):
    """finetune_highres from an 8 px-latent base to a 16 px config: with no
    step the weights are `upsample_denoiser_params` of the base; one epoch
    takes a step; a resume continues the step count."""
    base = Denoiser.from_config(pc.DenoiserConfig(**TINY)).state_dict()
    want = upsample_denoiser_params(base, 8, 16, 2)
    r0 = finetune_highres(_model_config(tmp_path, 16, n_epoch=0), base, 8, device="cpu")
    assert r0["global_step"] == 0
    for k, v in want.items():
        torch.testing.assert_close(r0["state"]["params"][k], v, atol=0, rtol=0)
    cfg = _model_config(tmp_path, 16, n=4, save_model=True, model_name="ft")
    r1 = finetune_highres(cfg, base, 8, device="cpu")
    assert r1["global_step"] == 1 and np.isfinite(r1["losses"][0])
    cfg.train_config.from_scratch = False
    r2 = finetune_highres(cfg, base, 8, device="cpu")
    assert r2["global_step"] == 2
    with pytest.raises(TypeError, match="device"):
        finetune_highres(cfg, base, 8)


def test_train_main_builds_the_jax_kernel_flags(tmp_path):
    """train.main's model: the JAX defaults of resolve_fused_flags (the
    fused MLP on CUDA only where the fused layer is off), remat on from
    2048 tokens over every bucket unless set, use_pallas on CUDA; the EMA
    weights in a model with no training kernels (JAX's eval_model)."""
    assert ttrain.resolve_fused_flags(pc.TrainConfig(), on_cuda=True) == (True, False, False)
    assert ttrain.resolve_fused_flags(pc.TrainConfig(fused_layer_vjp=True,
                                                     fused_mlp_vjp=True), False) == (True, True, False)
    assert ttrain.resolve_fused_flags(pc.TrainConfig(), on_cuda=False) == (False, False, False)
    cfg = _model_config(tmp_path, 8, n=4)
    lat, emb = _write(tmp_path, "big", 4, 64, 5)  # a 32 x 32-token bucket: 1024 tokens
    cfg.data_config.extra_latent_paths, cfg.data_config.extra_text_emb_paths = (lat,), (emb,)
    cfg.train_config.n_epoch = 0
    r = ttrain.main(cfg, device="cpu")
    assert not r["model"].denoiser_trans_block.remat  # 1024 < 2048 tokens
    big = pc.DenoiserConfig(**{**TINY, "image_size": 8, "patch_size": 1})  # 64 tokens
    cfg.denoiser_config = big
    lat, emb = _write(tmp_path, "huge", 4, 48, 6)  # 48 x 48 = 2304 tokens at patch 1
    cfg.data_config.extra_latent_paths, cfg.data_config.extra_text_emb_paths = (lat,), (emb,)
    r = ttrain.main(cfg, device="cpu")
    assert r["model"].denoiser_trans_block.remat
    ema = r["ema_model"]
    assert not any(b.fused_layer_vjp or b.mlp.fused_vjp
                   for b in ema.denoiser_trans_block.decoder_blocks)
    cfg.train_config.remat = False
    assert not ttrain.main(cfg, device="cpu")["model"].denoiser_trans_block.remat
