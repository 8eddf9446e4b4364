"""Reverse-diffusion sampling, PyTorch.

Counterpart of the JAX package's `sampling/diffusion.py`: the
linear-interpolation noise schedule with its first level clamped to 0.99,
DDIM or DPM-Solver++(2M) updates, classifier-free guidance by batch
doubling, the final extra denoise, the sharp/bright latent shifts, and
the VAE decode with a scale factor. The JAX package runs the steps as one
`lax.scan`; here they are a Python loop over the steps, each a few
kernel launches on the device.

The schedule's coefficients are computed on the host in float64 and
rounded to float32 once, as the JAX package passes them to its scan.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from transformer_latent_diffusion_tpu_torch.models.denoiser import (
    resize_pos_embed,
)

NOISE_SCHEDULES = ("poly", "cosine", "karras")
PREDICTION_OBJECTIVES = ("x0", "eps", "v")


def make_noise_levels(n_iter: int, exponent: float = 1.0,
                      kind: str = "poly") -> np.ndarray:
    """n_iter strictly decreasing noise levels with levels[0] = 0.99.

    "poly": the reference `1 - t^exponent`; "cosine": `0.99 cos(t pi/2)`;
    "karras": Karras et al. 2022 rho=7 spacing of the noise-to-signal
    ratio s/(1-s) between 0.99 and 1/n_iter."""
    if kind == "poly":
        t = np.arange(0, 1, 1.0 / n_iter)
        levels = 1.0 - np.power(t, exponent)
    elif kind == "cosine":
        t = np.arange(0, 1, 1.0 / n_iter)
        levels = 0.99 * np.cos(t * np.pi / 2.0)
    elif kind == "karras":
        rho = 7.0
        s_max, s_min = 0.99, 1.0 / max(n_iter, 2)
        v_max, v_min = s_max / (1 - s_max), s_min / (1 - s_min)
        g = np.linspace(v_max ** (1 / rho), v_min ** (1 / rho), n_iter)
        v = g ** rho
        levels = v / (1.0 + v)
    else:
        raise ValueError(f"unknown noise schedule {kind!r}; expected one "
                         f"of {NOISE_SCHEDULES}")
    levels[0] = 0.99
    return levels.astype(np.float64)


def shift_noise_levels(levels: np.ndarray, shift: float) -> np.ndarray:
    """The SD3 schedule shift s' = k s / (1 + (k - 1) s), k > 0."""
    shift = float(shift)
    if shift <= 0.0:
        raise ValueError(f"schedule shift must be > 0, got {shift}")
    s = np.asarray(levels, dtype=np.float64)
    return shift * s / (1.0 + (shift - 1.0) * s)


def make_step_coeffs(noise_levels: np.ndarray,
                     use_ddpm_plus: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Per-step x0 combination D = c1[i] x0 + c2[i] x0_prev: DDIM is (1, 0);
    DPM-Solver++(2M) uses r = h_{i-1}/h_i of the log-SNR steps."""
    n_steps = len(noise_levels) - 1
    c1 = np.ones(n_steps)
    c2 = np.zeros(n_steps)
    if use_ddpm_plus and n_steps >= 2:
        lambdas = [math.log((1 - s) / s) for s in noise_levels]
        hs = [lambdas[i] - lambdas[i - 1] for i in range(1, len(lambdas))]
        rs = [hs[i - 1] / hs[i] for i in range(1, len(hs))]
        for i in range(1, n_steps):
            r = rs[i - 1]
            c1[i] = 1.0 + 1.0 / (2.0 * r)
            c2[i] = -1.0 / (2.0 * r)
    return c1, c2


def prediction_to_x0(pred, x_t, sigma, objective: str):
    """Network prediction -> x0 estimate under x_t = s eps + (1 - s) x0.
    sigma: a scalar, or per-sample (n,) / (n, 1)."""
    if objective == "x0":
        return pred
    s = torch.as_tensor(sigma, dtype=pred.dtype, device=pred.device)
    if s.ndim:
        s = s.reshape(-1, *([1] * (pred.ndim - 1)))
    if objective == "v":
        return x_t - s * pred
    if objective == "eps":
        return (x_t - s * pred) / (1.0 - s)
    raise ValueError(f"unknown objective {objective!r}; expected one of "
                     f"{PREDICTION_OBJECTIVES}")


def cfg_combine(cond, uncond, class_guidance):
    """Classifier-free guidance g cond + (1 - g) uncond; g a scalar or a
    per-image vector (num,)."""
    g = class_guidance
    if isinstance(g, torch.Tensor) and g.ndim == 1:
        g = g.reshape(-1, *([1] * (cond.ndim - 1)))
    return g * cond + (1.0 - g) * uncond


def _as_f32(x, device) -> torch.Tensor:
    """A tensor or array-like as a float32 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class DiffusionGenerator:
    """Reverse-diffusion generator over a denoiser and an optional VAE.

    model: the plain `Denoiser` (its parameters are what the fused engine
    packs). fast_apply: an engine with `prepare(state_dict)` and
    `apply_prepared(prepared, x, noise_level, label)` (the fused engine),
    which runs the model on grids of at most 16 x 16 tokens at the native
    size, as the JAX package gates it (sampling/diffusion.py:304-334);
    otherwise, or with None, `model` itself runs. vae: an object with
    `decode(latents_nchw)`, or None to return latents only. device: where
    sampling runs, a required keyword ("cuda" or "cpu"), as for
    `DiffusionTransformer`. pos_resize: on a grid other than the model's
    native one, None (the default) bilinear-resizes the learned positional
    table onto it (`resize_pos_embed`, once per `generate` call); False
    takes its first h*w rows (smaller grids only), as in the JAX package.
    """

    def __init__(self, model, vae=None, fast_apply=None, *, device,
                 prediction_type: Optional[str] = None, mesh: Any = None,
                 pos_resize: Optional[bool] = None):
        if mesh is not None:
            raise _not_ported("mesh-sharded generation", "item 14")
        self.model = model
        self.vae = vae
        self.fast_apply = fast_apply
        self.device = torch.device(device)
        self.prediction_type = prediction_type
        self.pos_resize = pos_resize

    def _resize_grid(self, size: int) -> Optional[int]:
        """The token grid to resize the positional table onto for latents
        of `size`, or None (the native grid, or pos_resize=False)."""
        patch = self.model.patch_size
        grid, native = size // patch, self.model.image_size // patch
        return grid if self.pos_resize is not False and grid != native else None

    def uses_engine(self, size: int) -> bool:
        """Whether latents of `size` run through `fast_apply`: the engine
        holds at most 16 x 16 tokens and the native positional table."""
        return (self.fast_apply is not None
                and size // self.model.patch_size <= 16
                and self._resize_grid(size) is None)

    def initialize_image(self, seeds, num_imgs: int, img_size: int,
                         seed: int) -> torch.Tensor:
        """Initial noise, float32 on the device. Drawn from a CPU
        `torch.Generator` seeded with `seed` and then moved, so a seed
        gives the same noise on every device. Port seeds do NOT reproduce
        the JAX package's threefry draws; pass `seeds` (explicit noise) to
        replay a JAX run."""
        if seeds is not None:
            return _as_f32(seeds, self.device)
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        shape = (num_imgs, self.model.n_channels, img_size, img_size)
        return torch.randn(shape, generator=gen,
                           dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def generate(
        self,
        labels,
        n_iter: int = 30,
        num_imgs: int = 16,
        class_guidance: float = 3,
        seed: int = 10,
        scale_factor: float = 8,
        img_size: int = 32,
        sharp_f: float = 0.1,
        bright_f: float = 0.1,
        exponent: float = 1,
        seeds=None,
        noise_levels=None,
        use_ddpm_plus: bool = True,
        cache_interval: int = 1,
        output: str = "float",
        negative_labels=None,
        init_latents=None,
        strength: float = 1.0,
        mask=None,
        context_latents=None,
        fresh_noise: bool = False,
        fresh_noise_keys=None,
        clamp_first: bool = True,
        cfg_rescale: float = 0.0,
        guidance_interval=None,
        sampler=None,
        schedule: str = "poly",
        eta: float = 0.0,
        schedule_shift=None,
    ):
        """Generate images by reverse diffusion.

        Returns (images, x0 latents (N, C, S, S) float32): images are
        (N, 3, H, W) float, or (N, H, W, 3) uint8 with output="uint8"
        (clip((x+1)/2) * 255 + 0.5, truncated), or None without a VAE.

        Runs DDIM (sampler="ddim" or use_ddpm_plus=False) or
        DPM-Solver++(2M), with CFG, negative labels, explicit initial
        noise (`seeds`), any of the three noise schedules and a float
        schedule shift. The other options of the JAX generator raise
        NotImplementedError naming their ROADMAP item."""
        if sampler is None:
            sampler = "dpm" if use_ddpm_plus else "ddim"
        if sampler == "heun":
            raise _not_ported("sampler='heun'", "item 9 (sampler extras)")
        if sampler not in ("ddim", "dpm"):
            raise ValueError(f"unknown sampler {sampler!r}; expected 'ddim', "
                             f"'dpm' or 'heun'")
        for name, value, default in (("eta", eta, 0.0),
                                     ("fresh_noise", fresh_noise, False),
                                     ("cfg_rescale", cfg_rescale, 0.0),
                                     ("guidance_interval", guidance_interval,
                                      None),
                                     ("fresh_noise_keys", fresh_noise_keys,
                                      None)):
            if value != default:
                raise _not_ported(name, "item 9 (sampler extras)")
        for name, value in (("init_latents", init_latents), ("mask", mask),
                            ("context_latents", context_latents)):
            if value is not None:
                raise _not_ported(name, "item 9 (editing)")
        if cache_interval != 1:
            raise _not_ported("cache_interval > 1 (block caching)",
                              "item 9 (sampler extras)")
        if output not in ("float", "uint8"):
            raise ValueError(f"unknown output {output!r}")

        use_ddpm_plus = sampler == "dpm"
        if noise_levels is None:
            noise_levels = make_noise_levels(n_iter, exponent, schedule)
        else:
            noise_levels = np.asarray(noise_levels, dtype=np.float64).copy()
            if clamp_first:
                noise_levels[0] = 0.99
        if schedule_shift is not None:
            if schedule_shift == "auto":
                schedule_shift = img_size / self.model.image_size
            if float(schedule_shift) != 1.0:
                noise_levels = shift_noise_levels(noise_levels, schedule_shift)
        c1, c2 = make_step_coeffs(noise_levels, use_ddpm_plus)
        levels = noise_levels.astype(np.float32)
        c1, c2 = c1.astype(np.float32), c2.astype(np.float32)

        pred_kind = self.prediction_type or str(
            getattr(self.model, "objective", "x0"))
        if pred_kind not in PREDICTION_OBJECTIVES:
            raise ValueError(f"unknown prediction_type {pred_kind!r}")

        dev = self.device
        x_t = self.initialize_image(seeds, num_imgs, img_size, seed)
        labels = _as_f32(labels, dev)
        uncond = (torch.zeros_like(labels) if negative_labels is None
                  else _as_f32(negative_labels, dev).expand_as(labels))
        labels_cat = torch.cat([labels, uncond], dim=0)
        guidance = torch.as_tensor(class_guidance, dtype=torch.float32,
                                   device=dev)

        size = x_t.shape[-1]
        engine = self.fast_apply if self.uses_engine(size) else None
        prepared = (engine.prepare(self.model.state_dict())
                    if engine is not None else None)
        # the resized positional table, once per call, outside the step loop
        resize_grid = self._resize_grid(size)
        pos = None
        if resize_grid is not None:
            patch = self.model.patch_size
            pos = resize_pos_embed(
                self.model.denoiser_trans_block.pos_embed.weight,
                self.model.image_size // patch, resize_grid)

        def pred_x0(x_t, noise_level):
            num = x_t.shape[0]
            x2 = torch.cat([x_t, x_t], dim=0)
            noises = torch.full((2 * num, 1), float(noise_level),
                                dtype=torch.float32, device=dev)
            if engine is not None:
                x0 = engine.apply_prepared(prepared, x2, noises, labels_cat)
            elif pos is not None:
                x0 = self.model(x2, noises, labels_cat, pos_embed_override=pos)
            else:
                x0 = self.model(x2, noises, labels_cat)
            out = cfg_combine(x0[:num], x0[num:], guidance)
            return prediction_to_x0(out, x_t, noise_level, pred_kind)

        x0_prev = torch.zeros_like(x_t)
        for i in range(len(levels) - 1):
            # float32 scalars, as the JAX scan sees them
            curr, nxt = float(levels[i]), float(levels[i + 1])
            x0 = pred_x0(x_t, curr)
            d = float(c1[i]) * x0 + float(c2[i]) * x0_prev
            x_t = (float(levels[i] - levels[i + 1]) * d + nxt * x_t) / curr
            x0_prev = x0
        # final extra denoise at the last level
        x0 = pred_x0(x_t, float(levels[-1]))

        x0[:, 3] += sharp_f
        x0[:, 0] += bright_f
        if self.vae is None:
            return None, x0
        img = self.vae.decode(x0 * scale_factor)
        if output == "uint8":
            u = torch.clamp((img.float() + 1.0) * 0.5, 0.0, 1.0) * 255.0 + 0.5
            img = u.permute(0, 2, 3, 1).to(torch.uint8)
        return img, x0
