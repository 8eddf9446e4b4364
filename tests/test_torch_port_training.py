"""The port's training slice against the JAX package's: the diffusion loss
and every gradient of a tiny fused-layer Denoiser on the JAX draws, the
flagship gradient fingerprint against the committed golden, Adam with its
schedules, clipping and EMA against optax, and `train.main` on the CPU
(loss goes down, checkpoint / run_id resume, validation loss, graceful
preemption, unported fields). Mirrors tests/test_training.py and
tests/test_preemption.py."""

import math
import os
import signal
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from transformer_latent_diffusion_tpu.configs import DenoiserConfig as JaxDenoiserConfig
from transformer_latent_diffusion_tpu.configs import TrainConfig as JaxTrainConfig
from transformer_latent_diffusion_tpu.models import Denoiser as JaxDenoiser
from transformer_latent_diffusion_tpu.models.torch_compat import (
    convert_torch_denoiser_state_dict,
)
from transformer_latent_diffusion_tpu.train import train as jtrain
from transformer_latent_diffusion_tpu.utils import init_denoiser_params
from transformer_latent_diffusion_tpu.utils.goldens import (
    BUDGET_TRAIN_F32_VS_GOLDEN,
    GOLDEN_DENOISER,
    TRAIN_GOLDEN_SPEC,
    fingerprint_max_rel,
    grad_fingerprint,
    load_train_golden,
)
from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.data.loader import LatentBatcher
from transformer_latent_diffusion_tpu_torch.models import blocks
from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
from transformer_latent_diffusion_tpu_torch.train import checkpoint as ck
from transformer_latent_diffusion_tpu_torch.train import train as ttrain

torch.set_num_threads(2)

TINY = dict(image_size=8, embed_dim=64, n_layers=2, noise_embed_dims=64)


def _jax_draws(rng, n, shape, train_cfg):
    """The draws of the JAX package's loss_fn (train.py:357-397) for
    `rng`, as numpy: noise level (before any shift), noise, label keep."""
    r_beta, r_noise, r_drop, _, _ = jax.random.split(rng, 5)
    nl = jtrain.sample_beta(r_beta, train_cfg.beta_a, train_cfg.beta_b, (n, 1))
    noise = jax.random.normal(r_noise, shape, dtype=jnp.float32)
    keep = jax.random.uniform(r_drop, (n, 1)) >= 0.15
    return {"noise_level": torch.from_numpy(np.array(nl)),
            "noise": torch.from_numpy(np.array(noise)),
            "keep": torch.from_numpy(np.array(keep))}


def _port_model(jcfg, params, dtype=torch.float32, fused=True):
    model = Denoiser.from_config(pc.DenoiserConfig(**asdict(jcfg)), dtype=dtype,
                                 fused_layer_vjp=fused)
    sd = convert.denoiser_state_dict(jax.tree.map(np.asarray, params), jcfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model


def _flax_grads(model, jcfg):
    return convert_torch_denoiser_state_dict(
        {n: p.grad for n, p in model.named_parameters()}, jcfg)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("objective,weighting", [("x0", None), ("v", "min_snr")])
def test_loss_and_grads_match_jax_on_jax_draws(objective, weighting):
    """Tiny Denoiser with fused_layer_vjp=True on both sides, the same
    weights (convert.py), the same batch and the JAX draws: the loss to
    1e-5 relative and every gradient leaf to rel-L2 1e-4 (float32; the
    two differ in summation order and the TPU kernel's erf polynomial)."""
    jcfg = JaxDenoiserConfig(**TINY, objective=objective)
    jmodel = JaxDenoiser(**asdict(jcfg), fused_layer_vjp=True)
    params = init_denoiser_params(jmodel, jcfg)
    jtc = JaxTrainConfig(loss_weighting=weighting, schedule_shift=2.0)
    rng_np = np.random.default_rng(7)
    x = rng_np.standard_normal((4, 4, 8, 8)).astype(np.float32)
    y = rng_np.standard_normal((4, 768)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    jloss, jgrads = jax.value_and_grad(
        jtrain.build_loss_fn(jmodel, jtc, 8.0))(params, jnp.asarray(x),
                                                jnp.asarray(y), rng)

    model = _port_model(jcfg, params)
    tc = pc.TrainConfig(loss_weighting=weighting, schedule_shift=2.0)
    loss_fn = ttrain.build_loss_fn(model, tc, 8.0)
    loss = loss_fn.loss_from_draws(model, torch.from_numpy(x), torch.from_numpy(y),
                                   **_jax_draws(rng, 4, x.shape, jtc))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = jax.tree_util.tree_leaves_with_path(_flax_grads(model, jcfg))
    want = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    assert len(got) == len(want)
    for path, g in got:
        assert _rel_l2(g, want[path]) < 1e-4, jax.tree_util.keystr(path)


def test_flagship_grad_fingerprint_matches_golden():
    """The flagship 101M denoiser at float32 on the CPU, through the fused
    layer's plain versions, on the TRAIN_GOLDEN_SPEC batch with the JAX
    draws: the per-leaf gradient fingerprint against
    tests/goldens/train_grads.npz (the JAX package's CPU float32 grads)
    within BUDGET_TRAIN_F32_VS_GOLDEN (0.05). Measured 2.5e-7 (PERF.md)."""
    spec = TRAIN_GOLDEN_SPEC
    jcfg = JaxDenoiserConfig(**GOLDEN_DENOISER)
    params = init_denoiser_params(JaxDenoiser(**asdict(jcfg)), jcfg)
    model = _port_model(jcfg, params)
    del params
    shape = (spec["batch"], jcfg.n_channels, jcfg.image_size, jcfg.image_size)
    x = jax.random.normal(jax.random.PRNGKey(spec["latent_seed"]), shape, jnp.float32)
    y = jax.random.normal(jax.random.PRNGKey(spec["label_seed"]),
                          (spec["batch"], jcfg.text_emb_size), jnp.float32)
    jtc = JaxTrainConfig(batch_size=spec["batch"])
    draws = _jax_draws(jax.random.PRNGKey(spec["rng_seed"]), spec["batch"], shape, jtc)
    loss_fn = ttrain.build_loss_fn(model, pc.TrainConfig(batch_size=spec["batch"]), 8.0)
    loss_fn.loss_from_draws(model, torch.from_numpy(np.array(x)),
                            torch.from_numpy(np.array(y)), **draws).backward()
    fp = grad_fingerprint(_flax_grads(model, jcfg))
    rel = fingerprint_max_rel(fp, load_train_golden())
    print(f"flagship grad fingerprint vs golden: max leaf rel {rel:.3e}")
    assert rel < BUDGET_TRAIN_F32_VS_GOLDEN


@pytest.mark.parametrize("knobs", [
    dict(warmup_steps=2),
    dict(warmup_steps=1, lr_schedule="cosine", lr_decay_steps=2,
         lr_final_frac=0.1, grad_clip_norm=0.5),
])
def test_optimizer_and_ema_match_optax(knobs):
    """Three updates of the port's Adam (schedule, clipping) and EMA on the
    same gradients as the JAX package's make_optimizer / update_ema:
    float32, 1e-6 relative (the same formulas, other summation order)."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((8, 4)).astype(np.float32),
          "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    tx = jtrain.make_optimizer(JaxTrainConfig(lr=1e-2, **knobs))
    jp = jax.tree.map(jnp.asarray, p0)
    jema = jax.tree.map(jnp.asarray, p0)
    opt_state = tx.init(jp)

    tp = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in ("w", "b")]
    tema = [t.detach().clone() for t in tp]
    tc = pc.TrainConfig(lr=1e-2, **knobs)
    opt, sched = ttrain.make_optimizer(tc, tp)
    for g in grads:
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        jema = jtrain.update_ema(jema, jp, 0.9)
        for t, k in zip(tp, ("w", "b")):
            t.grad = torch.from_numpy(g[k].copy())
        ttrain.clip_by_global_norm_([t.grad for t in tp], tc.grad_clip_norm)
        opt.step()
        sched.step()
        ttrain.update_ema(tema, tp, 0.9)
    for i, k in enumerate(("w", "b")):
        np.testing.assert_allclose(tp[i].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tema[i].numpy(), np.asarray(jema[k]),
                                   rtol=1e-6, atol=1e-7)


def test_sample_beta_inverse_cdf():
    """Beta(1, b) and Beta(a, 1) by the inverse CDF: the sample mean and
    the Beta mean a / (a + b) agree to 1% on 200k draws."""
    gen = torch.Generator().manual_seed(0)
    for a, b in ((1.0, 2.5), (3.0, 1.0), (2.0, 3.0)):
        s = ttrain.sample_beta(gen, a, b, (200_000,))
        assert float(s.min()) >= 0.0 and float(s.max()) <= 1.0
        assert abs(float(s.mean()) - a / (a + b)) < 0.01 * a / (a + b)


def test_latent_batcher_holdout(tmp_path):
    """The held-out tail never enters training batches (the JAX package's
    test_latent_batcher_holdout)."""
    n = 20
    lat = np.tile(np.arange(n, dtype=np.float32)[:, None, None, None], (1, 4, 8, 8))
    txt = np.tile(np.arange(n, dtype=np.float32)[:, None], (1, 16))
    lp, tp = str(tmp_path / "l.npy"), str(tmp_path / "t.npy")
    np.save(lp, lat)
    np.save(tp, txt)
    b = LatentBatcher(lp, tp, batch_size=4, holdout=6)
    assert b.n == 14 and b.steps_per_epoch == 3
    seen = set()
    for x, _ in b.epoch():
        assert x.shape == (4, 4, 8, 8) and x.dtype == np.float32
        seen.update(np.unique(x).astype(int).tolist())
    assert max(seen) <= 13
    hx, hy = b.holdout_batch()
    np.testing.assert_array_equal(np.unique(hx), np.arange(14, 20))
    assert hy.shape == (6, 16)
    with pytest.raises(ValueError, match="holdout"):
        LatentBatcher(lp, tp, batch_size=4, holdout=20)


def test_checkpoint_step_overwrite_and_latest(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "run"))
    assert mgr.restore() is None
    mgr.save(0, {"w": torch.ones(3)})
    mgr.save(0, {"w": torch.full((3,), 7.0)})
    torch.testing.assert_close(mgr.restore(0)["w"], torch.full((3,), 7.0))
    for step in (1, 2, 3):
        mgr.save(step, {"w": torch.zeros(1), "step": step})
    assert mgr.all_steps() == [1, 2, 3] and mgr.latest_step() == 3
    assert mgr.restore()["step"] == 3


def _write_data(tmp_path, n=64, img_size=8):
    rng = np.random.default_rng(0)
    paths = [str(tmp_path / f) for f in ("latents.npy", "text_emb.npy", "val_emb.npy")]
    np.save(paths[0], rng.standard_normal((n, 4, img_size, img_size)).astype(np.float32))
    np.save(paths[1], rng.standard_normal((n, 768)).astype(np.float32))
    np.save(paths[2], rng.standard_normal((8, 768)).astype(np.float32))
    return pc.DataConfig(*paths)


def _cfg(tmp_path, **train_kw):
    kw = dict(n_epoch=2, batch_size=32, save_model=False,
              save_and_eval_every_iters=10 ** 9,
              checkpoint_dir=str(tmp_path / "ckpts"), fused_layer_vjp=True)
    kw.update(train_kw)
    return pc.ModelConfig(
        data_config=_write_data(tmp_path), denoiser_config=pc.DenoiserConfig(**TINY),
        train_config=pc.TrainConfig(**kw),
        vae_cfg=pc.VaeConfig(block_out_channels=(8, 16), layers_per_block=1))


def test_training_writes_eval_and_loss_decreases(tmp_path):
    """Eval grid at step 0 into the run directory, losses finite and
    falling on a memorizable dataset (the JAX package's test_training and
    test_training_loss_decreases)."""
    r = ttrain.main(_cfg(tmp_path, n_epoch=15, batch_size=64, lr=1e-3,
                         save_and_eval_every_iters=1000), device="cpu")
    assert r["global_step"] == 15
    losses = r["losses"]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5]), losses
    eval_dir = tmp_path / "ckpts" / "model" / "eval"
    assert (eval_dir / "emb_val_cfg:4.5_seed:10.png").exists()
    assert (eval_dir / "img.jpg").exists()


def test_checkpoint_resume_and_run_id(tmp_path):
    """Save, resume continues the step count with the EMA weights as the
    train weights; run_id resumes another run's checkpoint."""
    r1 = ttrain.main(_cfg(tmp_path, save_model=True, model_name="m0",
                          n_epoch=1, grad_accum_steps=2), device="cpu")
    assert r1["global_step"] == 2
    r2 = ttrain.main(_cfg(tmp_path, model_name="m0", from_scratch=False,
                          n_epoch=1), device="cpu")
    assert r2["global_step"] == 4
    r3 = ttrain.main(_cfg(tmp_path, model_name="m1", run_id="m0",
                          from_scratch=False, n_epoch=0), device="cpu")
    assert r3["global_step"] == 2
    for k, v in r1["state"]["ema_params"].items():
        torch.testing.assert_close(r3["state"]["params"][k], v, atol=0, rtol=0)


def test_training_val_loss(tmp_path):
    """val_holdout: a validation loss with fixed draws at every eval; the
    step-0 value repeats exactly in a second run."""
    cfg = _cfg(tmp_path, n_epoch=4, batch_size=16, val_holdout=16,
               save_and_eval_every_iters=6)
    r = ttrain.main(cfg, device="cpu")
    assert r["global_step"] == 12  # 48 examples / 16 x 4 epochs
    assert [s for s, _ in r["val_losses"]] == [0, 6]
    assert all(np.isfinite(v) for _, v in r["val_losses"])
    r2 = ttrain.main(_cfg(tmp_path, n_epoch=1, batch_size=16, val_holdout=16,
                          save_and_eval_every_iters=6), device="cpu")
    assert r2["val_losses"][0][1] == r["val_losses"][0][1]


def test_sigterm_stops_at_a_step_boundary_and_resumes(tmp_path, monkeypatch):
    """A SIGTERM during step 3 lets that step finish, saves a checkpoint
    of step 3 and returns preempted; from_scratch=False continues from it
    (the JAX package's test_preemption)."""
    real_step = ttrain.train_step

    def step_then_signal(state, *a, **kw):
        out = real_step(state, *a, **kw)
        if state["step"] == 3:
            signal.raise_signal(signal.SIGTERM)
        return out

    monkeypatch.setattr(ttrain, "train_step", step_then_signal)
    r = ttrain.main(_cfg(tmp_path, n_epoch=100, save_model=True), device="cpu")
    assert r["preempted"] and r["global_step"] == 3
    assert ck.CheckpointManager(str(tmp_path / "ckpts" / "model")).latest_step() == 3
    assert signal.getsignal(signal.SIGTERM) is not None
    monkeypatch.setattr(ttrain, "train_step", real_step)
    r2 = ttrain.main(_cfg(tmp_path, n_epoch=1, from_scratch=False), device="cpu")
    assert not r2["preempted"] and r2["global_step"] == 5


@pytest.mark.parametrize("field,value", [
    ("mesh_shape", (8, 1)), ("fsdp", True), ("pipeline_parallel", True),
    ("sequence_parallel", True), ("lora_rank", 4), ("outpaint", True),
    ("fused_mlp_vjp", True), ("fused_attn_vjp", True), ("remat", True),
    ("use_wandb", True), ("schedule_shift", "auto"), ("param_dtype", "bfloat16"),
])
def test_unported_train_field_raises(tmp_path, field, value):
    """A field whose feature the port does not run raises, naming it.
    fused_mlp_vjp=True, remat=True and schedule_shift="auto" came with
    hi-res training, fused_attn_vjp=True with the attention pair K6,
    outpaint=True with editing: each now trains one CPU step with the
    feature on (the MLP and attention flags here without the fused layer,
    remat on the model; "auto" on the native bucket is no shift, so its
    loss equals schedule_shift=None's; outpaint on a widened model, after
    the JAX package's ValueError for a plain one)."""
    ported = ("fused_mlp_vjp", "fused_attn_vjp", "remat", "schedule_shift", "outpaint")
    if field not in ported:
        with pytest.raises(NotImplementedError, match=field):
            ttrain.main(_cfg(tmp_path, **{field: value}), device="cpu")
        return
    one_step = dict(n_epoch=1, batch_size=64)
    if field in ("fused_mlp_vjp", "fused_attn_vjp"):
        one_step["fused_layer_vjp"] = None
    cfg = _cfg(tmp_path, **one_step, **{field: value})
    if field == "outpaint":
        with pytest.raises(ValueError, match="input_channels"):
            ttrain.main(cfg, device="cpu")
        cfg.denoiser_config.input_channels = 8
    r = ttrain.main(cfg, device="cpu")
    assert r["global_step"] == 1 and np.isfinite(r["losses"][0])
    tb = r["model"].denoiser_trans_block
    if field == "fused_mlp_vjp":
        assert all(b.mlp.fused_vjp for b in tb.decoder_blocks)
    elif field == "fused_attn_vjp":
        assert all(b.fused_attn_vjp and not b.fused_layer_vjp for b in tb.decoder_blocks)
    elif field == "remat":
        assert tb.remat
    elif field == "outpaint":
        assert tb.patchify_and_embed[0].in_channels == 8
    else:
        base = ttrain.main(_cfg(tmp_path, **one_step), device="cpu")
        assert r["losses"] == base["losses"]


def test_unported_model_fields_raise(tmp_path):
    """mlp_class="moe" raised before the MoE FFN was ported; now a fused-
    layer MoE model trains one CPU step, its blocks taking K6's route (the
    JAX block's want_attn) with the Switch loss in the objective."""
    cfg = _cfg(tmp_path, n_epoch=1, batch_size=64)
    cfg.denoiser_config.mlp_class = "moe"
    r = ttrain.main(cfg, device="cpu")
    assert r["global_step"] == 1 and np.isfinite(r["losses"][0])
    assert r["model"].mlp_class == "moe" and float(r["model"].moe_aux_loss().detach()) > 0
    # multires buckets came with hi-res training: a 2x bucket trains
    # beside the native one, and unpaired paths raise
    cfg = _cfg(tmp_path, n_epoch=1)
    lat, emb = str(tmp_path / "x2_lat.npy"), str(tmp_path / "x2_emb.npy")
    np.save(lat, np.random.default_rng(1).standard_normal((64, 4, 16, 16)).astype(np.float32))
    np.save(emb, np.random.default_rng(2).standard_normal((64, 768)).astype(np.float32))
    cfg.data_config.extra_latent_paths = (lat,)
    cfg.data_config.extra_text_emb_paths = (emb,)
    r = ttrain.main(cfg, device="cpu")
    assert r["global_step"] == 4 and all(np.isfinite(r["losses"]))
    cfg.data_config.extra_text_emb_paths = ()
    with pytest.raises(ValueError, match="extra_latent_paths"):
        ttrain.main(cfg, device="cpu")


@pytest.mark.parametrize("image_size,patch_size", [(64, 2), (36, 2), (32, 1)])
def test_train_beyond_fused_layer_tokens_raises(tmp_path, image_size, patch_size,
                                                monkeypatch):
    """More than 256 tokens (1024, 324, 1024) raised before hi-res training
    was ported; now a fused-layer model of that size trains one CPU step,
    its blocks beyond K2's gate taking K5's route for the MLP (one call
    per layer in the forward), with remat off below 2048 tokens."""
    cfg = _cfg(tmp_path, n_epoch=1, batch_size=2)
    cfg.denoiser_config.image_size = image_size
    cfg.denoiser_config.patch_size = patch_size
    rng = np.random.default_rng(0)
    np.save(cfg.data_config.latent_path,
            rng.standard_normal((2, 4, image_size, image_size)).astype(np.float32))
    np.save(cfg.data_config.text_emb_path,
            rng.standard_normal((2, 768)).astype(np.float32))
    calls = []
    real = blocks.fused_mlp_sepconv
    monkeypatch.setattr(blocks, "fused_mlp_sepconv", lambda *a: calls.append(a[-1]) or real(*a))
    # the step-0 eval grid (16 images x 40 steps on the CPU) is not what is
    # checked here: a blank image stands in for it
    monkeypatch.setattr(ttrain, "eval_gen", lambda diffuser, labels, size, out_dir: (
        os.makedirs(out_dir, exist_ok=True), Image.new("RGB", (8, 8)))[1])
    r = ttrain.main(cfg, device="cpu")
    assert r["global_step"] == 1 and np.isfinite(r["losses"][0])
    assert calls == [image_size // patch_size] * TINY["n_layers"]
    assert not r["model"].denoiser_trans_block.remat


@pytest.mark.parametrize("n_tokens", [324, 200])
def test_fused_block_outside_gate_raises_off_cpu(n_tokens):
    """Outside the fused layer's gate a DecoderBlock with
    fused_layer_vjp=True takes the JAX block's component route. On a
    square grid (324 tokens) that is K5 for the MLP; on a grid that is not
    square (200 tokens, with the plain MLP, since the sep-conv one needs a
    square grid in both packages) the attention pair K6, which raised
    NotImplementedError off the CPU before K6 was ported. Either block
    now matches the JAX block (float32, the kernel in interpret mode
    there) to rel-L2 1e-5, and off the CPU the kernel's wrapper takes the
    tensors (on the meta device, which needs no card, it refuses them as
    not CUDA)."""
    from transformer_latent_diffusion_tpu.models.blocks import MLP as JaxMLP
    from transformer_latent_diffusion_tpu.models.blocks import DecoderBlock as JaxBlock
    from transformer_latent_diffusion_tpu.models.blocks import MLPSepConv as JaxSepConv

    square = math.isqrt(n_tokens) ** 2 == n_tokens
    mlp_class = "sep_conv" if square else "mlp"
    block = blocks.DecoderBlock(64, 4, fused_layer_vjp=True, mlp_class=mlp_class)
    x, y = torch.zeros(1, n_tokens, 64), torch.zeros(1, 2, 64)
    rng = np.random.default_rng(n_tokens)
    xs = rng.standard_normal((1, n_tokens, 64)).astype(np.float32)
    ys = rng.standard_normal((1, 2, 64)).astype(np.float32)
    jblock = JaxBlock(embed_dim=64, mlp_multiplier=4, dropout_level=0.0,
                      fused_layer_vjp=True, mlp_class=JaxSepConv if square else JaxMLP)
    params = jblock.init(jax.random.PRNGKey(0), jnp.asarray(xs), jnp.asarray(ys))["params"]
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(xs), jnp.asarray(ys)))
    block.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.decoder_block_state_dict(
                               jax.tree.map(np.asarray, params)).items()})
    with torch.no_grad():
        got = block(torch.from_numpy(xs), torch.from_numpy(ys)).numpy()
    assert _rel_l2(got, want) < 1e-5
    block.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        block(x.to("meta"), y.to("meta"))


def test_main_requires_a_device(tmp_path):
    with pytest.raises(TypeError, match="device"):
        ttrain.main(_cfg(tmp_path))


def test_fused_layer_off_raises_on_cuda():
    """fused_layer_vjp=False on CUDA raises (no switch off the kernels);
    auto is the fused layer on CUDA and the plain path on the CPU."""
    assert ttrain.resolve_fused_flags(pc.TrainConfig(), on_cuda=True)[0]
    assert not ttrain.resolve_fused_flags(pc.TrainConfig(), on_cuda=False)[0]
    with pytest.raises(NotImplementedError, match="fused_layer_vjp"):
        ttrain.resolve_fused_flags(pc.TrainConfig(fused_layer_vjp=False), on_cuda=True)
