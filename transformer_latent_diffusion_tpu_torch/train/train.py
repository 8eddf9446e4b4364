"""Training loop of the port: `main(ModelConfig, device)`.

Counterpart of the JAX package's `train/train.py`: in-memory .npy latent
and text-embedding data, Beta(a, b) noise-level draws, the interpolation
corruption x_t = s eps + (1 - s) x, classifier-free-guidance label dropout
(p = 0.15 -> zero vector), MSE on the objective's target (x0, eps or v,
optionally min-SNR weighted), Adam with an optional warmup / cosine
schedule and global-norm clipping, EMA, periodic eval images and
checkpoints, held-out validation loss, resume and graceful preemption.

PyTorch runs eagerly, so the JAX package's one jitted step becomes a
Python step over an `nn.Module` with float32 master weights computing in
`compute_dtype`. On CUDA its decoder blocks take the hand-written kernels
by the JAX package's gates: K2 (`ops/fused_layer_vjp.py`) on square grids
of at most 256 tokens with the sep-conv FFN; the attention pair K6
(`ops/fused_attn_vjp.py`) in the other blocks of at most 256 tokens (the
"mlp" and "moe" FFNs, whose MoE adds its Switch load-balancing loss);
beyond, flash attention with its backward (K3/K4, `ops/attention.py`)
and, up to 1024 tokens, the sep-conv MLP's K5 (`ops/fused_mlp_vjp.py`);
per-block remat from 2048 tokens. Multires buckets
(`DataConfig.extra_latent_paths`) interleave whole batches, and a bucket
off the native grid trains the positional table through a differentiable
bilinear resize inside the loss. `TrainConfig.outpaint` fine-tunes a
widened-input model (`expand_input_channels`): each example's input is
its noisy latent, then a random edge strip of its clean latent as
context. The eval grid samples the
EMA weights through the K1 engine on a sep-conv model's native grid of at
most 256 tokens, else through a Denoiser with flash attention only (the
JAX package's `eval_model`). The random draws come from a
`torch.Generator` on the device, reseeded per step from (seed, step);
they do not reproduce the JAX package's threefry draws, so the loss is
split into `sample_draws` and a pure `loss_from_draws`, through which a
test feeds the JAX draws.
"""

from __future__ import annotations

import math
import os
import signal
from typing import Any, Dict, Optional

import numpy as np
import torch

from transformer_latent_diffusion_tpu_torch.configs import (
    ModelConfig,
    check_train_config,
    resolve_dtype,
)
from transformer_latent_diffusion_tpu_torch.data.loader import LatentBatcher
from transformer_latent_diffusion_tpu_torch.models.denoiser import (
    Denoiser,
    resize_pos_embed,
)
from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import (
    make_fused_apply,
)
from transformer_latent_diffusion_tpu_torch.models.vae import VaeDecoder
from transformer_latent_diffusion_tpu_torch.sampling.diffusion import (
    DiffusionGenerator,
)
from transformer_latent_diffusion_tpu_torch.train.checkpoint import (
    CheckpointManager,
)
from transformer_latent_diffusion_tpu_torch.utils.common import (
    count_parameters,
    init_random_weights_,
    load_state_dict_file,
    uint8_grid_to_pil,
)
from transformer_latent_diffusion_tpu_torch.utils.profiling import StepTimer


def sample_beta(generator: torch.Generator, a: float, b: float, shape):
    """Beta(a, b) draws on the generator's device. a == 1 or b == 1 (the
    reference's Beta(1, 2.5)) use the exact inverse CDF of one uniform
    draw, 1 - U^(1/b) or U^(1/a); other (a, b) draw with numpy seeded from
    the generator."""
    dev = generator.device
    if a == 1.0:
        u = torch.rand(shape, generator=generator, device=dev)
        return 1.0 - torch.pow(u, 1.0 / b)
    if b == 1.0:
        return torch.pow(torch.rand(shape, generator=generator, device=dev),
                         1.0 / a)
    seed = int(torch.randint(2 ** 62, (1,), generator=generator, device=dev))
    draws = np.random.default_rng(seed).beta(a, b, shape).astype(np.float32)
    return torch.from_numpy(draws).to(dev)


@torch.no_grad()
def update_ema(ema_params, params, alpha: float = 0.999):
    """In place: ema = alpha * ema + (1 - alpha) * p, over two matching
    sequences of tensors."""
    ema_params, params = list(ema_params), list(params)
    torch._foreach_mul_(ema_params, alpha)
    torch._foreach_add_(ema_params, params, alpha=1.0 - alpha)
    return ema_params


def eval_gen(diffuser: DiffusionGenerator, labels, img_size: int,
             out_dir: str = "."):
    """In-training eval grid: 16 images of the 8 eval embeddings (each
    twice), CFG 4.5, seed 10, 40 steps, written to `out_dir` as the JAX
    package names it. Returns the PIL image."""
    class_guidance = 4.5
    seed = 10
    labels = np.repeat(np.asarray(labels, np.float32), 2, axis=0)
    out, _ = diffuser.generate(labels=labels, num_imgs=16,
                               class_guidance=class_guidance, seed=seed,
                               n_iter=40, exponent=1, sharp_f=0.1,
                               img_size=img_size, output="uint8")
    img = uint8_grid_to_pil(out.cpu().numpy(), nrow=8, padding=4)
    os.makedirs(out_dir, exist_ok=True)
    img.save(os.path.join(out_dir,
                          f"emb_val_cfg:{class_guidance}_seed:{seed}.png"))
    return img


class GracefulShutdown:
    """SIGTERM/SIGINT -> finish the current step, checkpoint, return.

    A signal sets `requested`; the loop stops at the next step boundary
    and the end-of-training save writes a resumable checkpoint. The
    previous handlers come back on exit; installing from a thread other
    than the main one does nothing (signal.signal raises there)."""

    def __init__(self, enabled: bool = True):
        self.requested = False
        self.enabled = enabled
        self._prev = {}

    def __enter__(self):
        if not self.enabled:
            return self

        def _handler(signum, frame):
            self.requested = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, _handler)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}
        return False


def lr_factor(train_cfg, step: int) -> float:
    """The JAX package's optax schedule (make_optimizer) at update `step`,
    as a fraction of train_cfg.lr: linear warmup from 0, then constant, or
    a cosine decay to lr * lr_final_frac over lr_decay_steps, then held."""
    warmup = int(train_cfg.warmup_steps or 0)
    kind = train_cfg.lr_schedule or "constant"
    if kind == "constant":
        return step / warmup if step < warmup else 1.0
    if kind != "cosine":
        raise ValueError(f"unknown lr_schedule {kind!r}; expected None, "
                         f"'constant' or 'cosine'")
    if step < warmup:
        return step / warmup
    decay = int(train_cfg.lr_decay_steps)
    frac = float(train_cfg.lr_final_frac)
    t = min(step - warmup, decay)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
    return (1.0 - frac) * cosine + frac


def make_optimizer(train_cfg, params):
    """(Adam, its LambdaLR schedule) over `params`: optax.adam's defaults
    (b1 0.9, b2 0.999, eps 1e-8) and the JAX package's schedule. Global-
    norm clipping (train_cfg.grad_clip_norm) is applied by `train_step`
    before Adam, as optax.chain(clip_by_global_norm, adam) does."""
    kind = train_cfg.lr_schedule or "constant"
    if kind == "cosine" and int(train_cfg.lr_decay_steps or 0) <= 0:
        raise ValueError("lr_schedule='cosine' requires lr_decay_steps > 0")
    lr_factor(train_cfg, 0)  # rejects an unknown schedule now
    opt = torch.optim.Adam(params, lr=train_cfg.lr, betas=(0.9, 0.999),
                           eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: lr_factor(train_cfg, step))
    return opt, sched


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: Optional[float]):
    """The global L2 norm of `grads` (before clipping); with max_norm,
    scale them in place by max_norm / norm where norm > max_norm, as
    optax.clip_by_global_norm does."""
    grads = list(grads)
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    if max_norm:
        scale = torch.where(norm > max_norm, max_norm / norm,
                            torch.ones_like(norm))
        torch._foreach_mul_(grads, scale)
    return norm


def resolve_fused_flags(train_cfg, on_cuda: bool):
    """(fused_layer, fused_mlp, fused_attn), the JAX package's defaults
    (train.py:204-212) with CUDA for the TPU. None = auto: the fused layer
    (K2) on CUDA, the plain autograd path on the CPU; the fused MLP (K5)
    and the fused attention pair (K6) on CUDA where the fused layer is
    off. A fused-layer block that K2 does not take (the "mlp" and "moe"
    FFNs) runs K6 all the same (models.blocks.DecoderBlock). On CUDA the
    port has no switch off its kernels, so fused_layer_vjp=False raises
    there."""
    fused_layer = (train_cfg.fused_layer_vjp
                   if train_cfg.fused_layer_vjp is not None else on_cuda)
    if on_cuda and not fused_layer:
        raise NotImplementedError(
            "TrainConfig.fused_layer_vjp=False: the port has no switch off "
            "its kernels; on CUDA the decoder layers always run them (the "
            "plain versions serve the CPU only)")
    fused_mlp = (train_cfg.fused_mlp_vjp
                 if train_cfg.fused_mlp_vjp is not None
                 else (on_cuda and not fused_layer))
    fused_attn = (train_cfg.fused_attn_vjp
                  if train_cfg.fused_attn_vjp is not None
                  else (on_cuda and not fused_layer))
    return bool(fused_layer), bool(fused_mlp), bool(fused_attn)


class DiffusionLoss:
    """The per-batch diffusion loss of `build_loss_fn`, in two parts:
    `sample_draws` (the random noise level, noise and label-dropout mask)
    and the pure `loss_from_draws`; calling it runs both.

    image_size, patch_size: the model's native size. A batch on another
    token grid adds the learned positional table bilinear-resized onto its
    grid (differentiable: every bucket trains the one table), and
    schedule_shift="auto" shifts by the batch's size over the native one
    (1.0, the native bucket, is no shift), as the JAX package's
    `_pos_override` and `_resolve_shift` do. A "moe" model adds
    `moe_aux_weight` times its Switch load-balancing loss (the JAX
    package's sown "losses", train.py:403-416). With train_cfg.outpaint
    the model's input is [x_noisy, m x], m a random edge strip of each
    example (`sample_draws`' "context_mask"), as the JAX package's
    `_outpaint_context`."""

    def __init__(self, train_cfg, vae_scale_factor: float,
                 objective: str = "x0", image_size: Optional[int] = None,
                 patch_size: Optional[int] = None):
        shift = train_cfg.schedule_shift
        if shift == "auto":
            if not image_size:
                raise ValueError("schedule_shift='auto' needs the model's "
                                 "native image_size; pass a float shift")
        elif shift is not None:
            shift = float(shift)
            if shift <= 0.0:
                raise ValueError(f"schedule_shift must be > 0 or 'auto', "
                                 f"got {shift}")
        self.shift = shift
        self.image_size, self.patch_size = image_size, patch_size
        if objective not in ("x0", "eps", "v"):
            raise ValueError(f"unknown objective {objective!r}")
        self.objective = objective
        if train_cfg.loss_weighting not in (None, "min_snr"):
            raise ValueError(f"unknown loss_weighting "
                             f"{train_cfg.loss_weighting!r}; expected None "
                             f"or 'min_snr'")
        self.weighting = train_cfg.loss_weighting
        self.gamma = float(train_cfg.min_snr_gamma)
        self.offset_noise = float(train_cfg.offset_noise)
        self.beta = (float(train_cfg.beta_a), float(train_cfg.beta_b))
        self.vae_scale_factor = float(vae_scale_factor)
        self.moe_aux_weight = float(train_cfg.moe_aux_weight)
        self.outpaint = bool(train_cfg.outpaint)

    def sample_draws(self, generator: torch.Generator, x) -> Dict[str, Any]:
        """noise_level (n, 1) ~ Beta(a, b) (before any schedule shift),
        noise like x (plus offset_noise times a per-(sample, channel)
        draw), keep (n, 1): False for the 15% of labels dropped; with
        outpaint, context_mask (n, 1, h, w) (`outpaint_context_mask`)."""
        n = x.shape[0]
        dev = generator.device
        noise_level = sample_beta(generator, *self.beta, (n, 1))
        noise = torch.randn(x.shape, generator=generator, device=dev)
        if self.offset_noise:
            noise = noise + self.offset_noise * torch.randn(
                (*x.shape[:2], 1, 1), generator=generator, device=dev)
        keep = torch.rand((n, 1), generator=generator, device=dev) >= 0.15
        draws = {"noise_level": noise_level, "noise": noise, "keep": keep}
        if self.outpaint:
            draws["context_mask"] = outpaint_context_mask(
                torch.randint(0, 4, (n,), generator=generator, device=dev),
                0.25 + 0.5 * torch.rand((n, 1), generator=generator, device=dev),
                torch.rand((n,), generator=generator, device=dev) < 0.1,
                *x.shape[-2:])
        return draws

    def _weight(self, s):
        """Per-sample min-SNR-gamma weight in the objective's target space
        (the JAX package's `_loss_weight`), or None."""
        if self.weighting is None:
            return None
        snr = ((1.0 - s) / s).square()
        w = torch.clamp(snr, max=self.gamma)
        if self.objective == "eps":
            w = w / snr
        elif self.objective == "v":
            w = w * s.square()
        return w

    def _resolve_shift(self, x) -> Optional[float]:
        if self.shift is None:
            return None
        k = x.shape[-1] / self.image_size if self.shift == "auto" else self.shift
        return None if k == 1.0 else k

    def _pos_override(self, model, x):
        """None on the native grid; else the master positional table
        resized onto the batch's grid."""
        if not (self.image_size and self.patch_size):
            return None
        grid = x.shape[-1] // self.patch_size
        native = self.image_size // self.patch_size
        if grid == native:
            return None
        return resize_pos_embed(model.denoiser_trans_block.pos_embed.weight,
                                native, grid)

    def loss_from_draws(self, model, x, y, noise_level, noise, keep,
                        context_mask=None):
        pos = self._pos_override(model, x)
        x = x / self.vae_scale_factor
        k = self._resolve_shift(x)
        if k is not None:
            noise_level = k * noise_level / (1.0 + (k - 1.0) * noise_level)
        nl = noise_level[:, :, None, None]
        x_noisy = nl * noise + (1.0 - nl) * x
        target = (x if self.objective == "x0" else noise
                  if self.objective == "eps" else noise - x)
        if context_mask is not None:
            # widened input: the noisy latent, then the masked clean latent;
            # the loss stays the whole image's
            x_noisy = torch.cat([x_noisy, context_mask.to(x.dtype) * x], dim=1)
        label = y * keep.to(y.dtype)
        pred = (model(x_noisy, noise_level, label) if pos is None else
                model(x_noisy, noise_level, label, pos_embed_override=pos))
        w = self._weight(noise_level.float())
        if w is None:
            loss = torch.mean((pred - target) ** 2)
        else:
            per = (pred - target).float().square().mean(tuple(range(1, pred.ndim)))
            loss = torch.mean(w[:, 0] * per)
        if getattr(model, "mlp_class", "sep_conv") == "moe":
            loss = loss + self.moe_aux_weight * model.moe_aux_loss()
        return loss

    def __call__(self, model, x, y, generator):
        return self.loss_from_draws(model, x, y, **self.sample_draws(generator, x))


def outpaint_context_mask(side, frac, zero, h: int, w: int) -> torch.Tensor:
    """The outpainting fine-tune's visible strip (n, 1, h, w) float32, as
    the JAX package's `_outpaint_context` builds it: per example a side
    (0 left, 1 right, 2 top, 3 bottom; side (n,) ints) whose fraction
    frac (n, 1) in [0.25, 0.75] of the columns or rows stays visible,
    and none where zero (n,) is true (about 10%: zero-context sampling
    keeps working)."""
    col = torch.arange(w, device=side.device)[None, :]
    row = torch.arange(h, device=side.device)[None, :]
    horiz = torch.where((side < 1)[:, None], col < torch.round(frac * w),
                        col >= w - torch.round(frac * w))
    vert = torch.where((side < 3)[:, None], row < torch.round(frac * h),
                       row >= h - torch.round(frac * h))
    m = torch.where((side < 2)[:, None, None], horiz[:, None, :],
                    vert[:, :, None])
    m = torch.where(zero[:, None, None], 0.0, m.float())
    return m[:, None]


def build_loss_fn(model, train_cfg, vae_scale_factor) -> DiffusionLoss:
    """The diffusion loss of the JAX package's build_loss_fn for `model`
    (its `objective` and native size)."""
    return DiffusionLoss(train_cfg, vae_scale_factor,
                         str(getattr(model, "objective", "x0")),
                         getattr(model, "image_size", None),
                         getattr(model, "patch_size", None))


def make_grads_of(loss_fn, accum: int = 1):
    """grads_of(model, x, y, generator) -> the mean loss, with the
    gradients of the mean over `accum` microbatches accumulated into the
    parameters' .grad (the JAX package's scan over microbatches)."""
    accum = max(1, accum)

    def grads_of(model, x, y, generator):
        total = 0.0
        for xi, yi in zip(x.chunk(accum), y.chunk(accum)):
            loss = loss_fn(model, xi, yi, generator) / accum
            loss.backward()
            total = total + loss.detach()
        return total

    return grads_of


def train_step(state: Dict[str, Any], grads_of, train_cfg, x, y, generator):
    """One update of `state` (model, ema_model, optimizer, scheduler,
    step) in place: gradients, clipping, Adam, the schedule, EMA. Returns
    (loss, the pre-clip global gradient norm), both device scalars."""
    model = state["model"]
    params = [p for p in model.parameters() if p.requires_grad]
    state["optimizer"].zero_grad(set_to_none=True)
    loss = grads_of(model, x, y, generator)
    gnorm = clip_by_global_norm_([p.grad for p in params],
                                 train_cfg.grad_clip_norm)
    state["optimizer"].step()
    state["scheduler"].step()
    update_ema(state["ema_model"].parameters(), model.parameters(),
               train_cfg.alpha)
    state["step"] += 1
    return loss, gnorm


def _interleave_epochs(batchers):
    """Whole batches round-robin across the resolution buckets until every
    bucket's epoch is done (the JAX package's `_interleave_epochs`); one
    batcher is its plain epoch."""
    iters = [b.epoch() for b in batchers]
    while iters:
        alive = []
        for it in iters:
            try:
                yield next(it)
            except StopIteration:
                continue
            alive.append(it)
        iters = alive


def _state_dict(state) -> Dict[str, Any]:
    return {"params": state["model"].state_dict(),
            "ema_params": state["ema_model"].state_dict(),
            "opt_state": {"optimizer": state["optimizer"].state_dict(),
                          "scheduler": state["scheduler"].state_dict()},
            "step": state["step"]}


def main(config: ModelConfig, device,
         init_state_dict: Optional[Dict[str, torch.Tensor]] = None
         ) -> Dict[str, Any]:
    """Train on `device` ("cuda" or "cpu", required). init_state_dict: a
    warm-start `Denoiser` state_dict (else seeded random weights). Returns
    the JAX package's result keys; "state" holds state_dicts, "model" and
    "ema_model" the modules."""
    check_train_config(config)
    denoiser_config = config.denoiser_config
    train_config = config.train_config
    dataconfig = config.data_config
    device = torch.device(device)
    on_cuda = device.type == "cuda"

    def log(*a):
        print(*a, flush=True)

    log("Loading Data:")
    batcher = LatentBatcher(dataconfig.latent_path, dataconfig.text_emb_path,
                            batch_size=train_config.batch_size,
                            seed=train_config.seed,
                            holdout=train_config.val_holdout)
    # multires buckets: one batcher per extra dataset, whole batches
    # interleaved so each keeps its static shape
    extra_lat = tuple(dataconfig.extra_latent_paths or ())
    extra_emb = tuple(dataconfig.extra_text_emb_paths or ())
    if len(extra_lat) != len(extra_emb):
        raise ValueError(f"extra_latent_paths ({len(extra_lat)}) and "
                         f"extra_text_emb_paths ({len(extra_emb)}) must pair up")
    batchers = [batcher] + [
        LatentBatcher(lp, ep, batch_size=train_config.batch_size,
                      seed=train_config.seed + 1 + i,
                      holdout=train_config.val_holdout)
        for i, (lp, ep) in enumerate(zip(extra_lat, extra_emb))]
    emb_val = np.load(dataconfig.val_path).astype(np.float32)
    in_ch = denoiser_config.input_channels or denoiser_config.n_channels
    if train_config.outpaint:
        if in_ch != 2 * denoiser_config.n_channels:
            raise ValueError(
                f"outpaint=True needs DenoiserConfig.input_channels == "
                f"2*n_channels ({2 * denoiser_config.n_channels}), got "
                f"{in_ch}; widen a trained checkpoint with "
                f"models.denoiser.expand_input_channels and pass it as "
                f"init_state_dict")
    elif in_ch != denoiser_config.n_channels:
        raise ValueError(
            f"input_channels={in_ch} != n_channels="
            f"{denoiser_config.n_channels} but outpaint=False: the train "
            f"step would feed the model {denoiser_config.n_channels}"
            f"-channel latents")

    compute_dtype = resolve_dtype(train_config.compute_dtype)
    fused_layer, fused_mlp, fused_attn = resolve_fused_flags(train_config,
                                                             on_cuda)
    # remat's auto choice covers the largest bucket of the run
    patch = denoiser_config.patch_size
    max_tokens = max([(denoiser_config.image_size // patch) ** 2] + [
        (b.latents.shape[-1] // patch) ** 2 for b in batchers[1:]])
    remat = (train_config.remat if train_config.remat is not None
             else max_tokens >= 2048)
    model = Denoiser.from_config(denoiser_config, dtype=compute_dtype,
                                 fused_layer_vjp=fused_layer,
                                 use_pallas=on_cuda, fused_mlp_vjp=fused_mlp,
                                 remat=remat, fused_attn_vjp=fused_attn)
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict)
    else:
        init_random_weights_(model, train_config.seed)
    model.to(device).train()
    # the EMA weights live in the JAX package's eval_model: flash attention
    # on CUDA, no training kernels (eval grid and validation loss only)
    ema_model = Denoiser.from_config(denoiser_config, dtype=compute_dtype,
                                     use_pallas=on_cuda)
    ema_model.load_state_dict(model.state_dict())
    ema_model.to(device).requires_grad_(False).eval()
    optimizer, scheduler = make_optimizer(train_config, model.parameters())
    state = {"model": model, "ema_model": ema_model, "optimizer": optimizer,
             "scheduler": scheduler, "step": 0}

    run_name = train_config.model_name or "model"
    run_dir = os.path.join(train_config.checkpoint_dir, run_name)
    ckpt_mgr = None
    if train_config.save_model or not train_config.from_scratch:
        ckpt_mgr = CheckpointManager(run_dir)
    # run_id selects which earlier run to resume from; new checkpoints
    # still save under this run's name
    restore_mgr = ckpt_mgr
    if (not train_config.from_scratch and train_config.run_id
            and train_config.run_id != run_name):
        restore_mgr = CheckpointManager(
            os.path.join(train_config.checkpoint_dir, train_config.run_id))
    if not train_config.from_scratch and restore_mgr is not None:
        log("Loading Model:")
        restored = restore_mgr.restore()
        if restored is not None:
            # resume loads the EMA weights into the train model (reference
            # semantics, as the JAX package)
            model.load_state_dict(restored["ema_params"])
            ema_model.load_state_dict(restored["ema_params"])
            optimizer.load_state_dict(restored["opt_state"]["optimizer"])
            scheduler.load_state_dict(restored["opt_state"]["scheduler"])
            state["step"] = int(restored["step"])

    loss_fn = build_loss_fn(model, train_config,
                            config.vae_cfg.vae_scale_factor)
    grads_of = make_grads_of(loss_fn, train_config.grad_accum_steps)

    vae = []  # built at the first eval

    def get_diffuser():
        if not vae:
            dec = VaeDecoder.from_config(config.vae_cfg)
            path = config.vae_cfg.weights_path
            if path and os.path.exists(path):
                dec.load_state_dict({k: v for k, v in load_state_dict_file(
                    path, "vae").items() if k.startswith(("decoder.", "post_quant_conv."))})
            else:
                init_random_weights_(dec, train_config.seed + 1)
            vae.append(dec.to(device, resolve_dtype(config.vae_cfg.vae_dtype)).eval())
        # the K1 engine packs the sep-conv layer; the other FFNs sample
        # through the linen path (flash attention on CUDA)
        engine = (make_fused_apply(denoiser_config, torch.bfloat16)
                  if on_cuda and denoiser_config.mlp_class == "sep_conv"
                  else None)
        return DiffusionGenerator(ema_model, vae=vae[0], fast_apply=engine,
                                  device=device)

    # every bucket's held-out tail, one fixed-draw loss each on the EMA
    # weights; `val_losses` is the native bucket's series
    val_sets = []
    val_losses = []
    val_losses_by_size = {}
    if train_config.val_holdout > 0:
        for b in batchers:
            vx, vy = b.holdout_batch()
            val_sets.append((int(vx.shape[-1]), torch.from_numpy(vx).to(device),
                             torch.from_numpy(vy).to(device)))
        val_gen = torch.Generator(device=device)

    log(f"{count_parameters(model)} parameters")

    step_gen = torch.Generator(device=device)
    timer = StepTimer()
    losses, grad_norms = [], []
    shutdown = GracefulShutdown(enabled=train_config.handle_signals)
    with shutdown:
        for epoch in range(1, train_config.n_epoch + 1):
            if shutdown.requested:
                break
            log(f"epoch: {epoch}")
            for x_host, y_host in _interleave_epochs(batchers):
                if shutdown.requested:
                    break
                x = torch.from_numpy(x_host).to(device, non_blocking=True)
                y = torch.from_numpy(y_host).to(device, non_blocking=True)
                step = state["step"]
                if step % train_config.save_and_eval_every_iters == 0:
                    eval_dir = os.path.join(run_dir, "eval")
                    out = eval_gen(get_diffuser(), emb_val,
                                   denoiser_config.image_size, eval_dir)
                    out.save(os.path.join(eval_dir, "img.jpg"))
                    rec = []
                    for bi, (size, vx, vy) in enumerate(val_sets):
                        val_gen.manual_seed(train_config.seed + 1_000_003)
                        with torch.no_grad():
                            vl = float(loss_fn(ema_model, vx, vy, val_gen))
                        if bi == 0:
                            val_losses.append((step, vl))
                            rec.append(f"val_loss {vl:.5f}")
                        val_losses_by_size.setdefault(size, []).append((step, vl))
                        rec.append(f"val_loss/{size} {vl:.5f}")
                    if rec:
                        log(f"step {step} " + " ".join(rec))
                    if train_config.save_model and ckpt_mgr is not None:
                        ckpt_mgr.save(step, _state_dict(state))

                step_gen.manual_seed((train_config.seed << 32) + step)
                loss, gnorm = train_step(state, grads_of, train_config, x, y,
                                         step_gen)
                losses.append(loss)
                if train_config.log_grad_norm:
                    grad_norms.append(gnorm)
                timer.tick()
                step = state["step"]
                if step % 16 == 0:
                    # one host sync per 16 steps bounds the launch queue
                    losses[-1] = float(losses[-1])
                    if step % 256 == 0:
                        log(f"step {step} loss {losses[-1]:.5f} "
                            f"{timer.step_ms:.0f} ms/step "
                            f"{timer.samples_per_sec(batcher.batch_size):.0f}"
                            f" samples/s")

    if shutdown.requested:
        log(f"preemption signal received: stopping at step {state['step']}")
    if train_config.save_model and ckpt_mgr is not None:
        ckpt_mgr.save(state["step"], _state_dict(state))
        if shutdown.requested:
            log(f"preemption checkpoint saved at step {state['step']}")

    losses = [float(v) for v in losses]
    grad_norms = [float(v) for v in grad_norms]
    if losses:
        log(f"final loss {np.mean(losses[-10:]):.5f}")
    return {"state": _state_dict(state), "model": model,
            "ema_model": ema_model, "losses": losses,
            "global_step": state["step"], "val_losses": val_losses,
            "val_losses_by_size": val_losses_by_size,
            "grad_norms": grad_norms, "preempted": shutdown.requested}
