"""Reverse-diffusion sampling, PyTorch.

Counterpart of the JAX package's `sampling/diffusion.py`: the
linear-interpolation noise schedule with its first level clamped to 0.99,
DDIM, DPM-Solver++(2M), Heun, eta-stochastic DDIM and fresh-noise
updates, classifier-free guidance by batch doubling (with guidance
rescale and a guidance interval), block caching on the fused engine, the
final extra denoise, the sharp/bright latent shifts, and the VAE decode
with a scale factor; and the editing inputs: img2img (`init_latents` and
`strength`), inpainting (a `mask` whose keep region is pinned to the
init's corruption at every step and comes out equal to the init) and a
widened model's context channels (`context_latents`, outpainting).

The JAX package runs the steps as one `lax.scan` under `jit`. Here the
steps are `sample_loop`, one function of tensors: every level,
coefficient, guidance value and option value is read from a device
tensor, as the scan reads its `xs`, so on CUDA the loop of a key called
again is captured once into a CUDA graph and replayed
(`sampling/graph.py`); the CPU runs the same function eagerly.

The schedule's coefficients and the options' scalars are computed on the
host in float64 and rounded to float32 once, as the JAX package passes
them to its scan.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from transformer_latent_diffusion_tpu_torch.models.denoiser import (
    resize_pos_embed,
)
from transformer_latent_diffusion_tpu_torch.sampling.graph import LoopGraphs

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


def fresh_noise_image_seeds(seed: int, num_imgs: int) -> List[int]:
    """Per-image fresh-noise seeds for `generate(fresh_noise=True)` or
    eta > 0: image j's step noise comes from a CPU `torch.Generator`
    seeded with the j-th value, a pure function of (seed, j). So an
    image's stream does not depend on the batch it sits in (a request's
    images sample alike solo or in a larger batch), nor on the initial
    noise drawn from the same seed. The counterpart of the JAX package's
    `fresh_noise_image_keys`; threefry keys cannot be reproduced here."""
    return [int(np.random.SeedSequence([int(seed), 1, j]).generate_state(
        1, np.uint64)[0]) for j in range(num_imgs)]


def draw_step_noise(image_seeds, n_steps: int, shape) -> torch.Tensor:
    """(n_steps, N, *shape) float32 on the CPU: image j's noise for step i
    is the i-th draw of `shape` from a generator seeded with
    image_seeds[j]."""
    per_image = []
    for s in image_seeds:
        gen = torch.Generator(device="cpu").manual_seed(int(s))
        per_image.append(torch.randn((n_steps, *shape), generator=gen,
                                     dtype=torch.float32))
    return torch.stack(per_image, dim=1).contiguous()


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


def _guided(cond, uncond, g):
    """g cond + (1 - g) uncond; g a scalar or a per-image vector (num,)."""
    if isinstance(g, torch.Tensor) and g.ndim == 1:
        g = g.reshape(-1, *([1] * (cond.ndim - 1)))
    return g * cond + (1.0 - g) * uncond


def cfg_combine(cond, uncond, class_guidance, sigma=None,
                cfg_rescale=0.0, guidance_interval=None):
    """Classifier-free guidance g cond + (1 - g) uncond; g a scalar or a
    per-image vector (num,). cfg_rescale in [0, 1] (Lin et al. 2023)
    blends in the combination rescaled to the cond half's per-sample std;
    guidance_interval=(lo, hi) (Kynkäänniemi et al. 2024) applies guidance
    only at noise levels sigma in [lo, hi] and returns cond elsewhere.

    cfg_rescale is a float (0: off), or the pair (r, 1 - r) of device
    scalars that `sample_loop` reads from `loop_scalars` (1 - r computed on
    the host); lo, hi and sigma are floats or device scalars. A float and
    a float32 device scalar of its value give the same result."""
    out = _guided(cond, uncond, class_guidance)
    if isinstance(cfg_rescale, tuple):
        rescale, keep = cfg_rescale
    else:
        rescale, keep = float(cfg_rescale), 1.0 - float(cfg_rescale)
    if isinstance(rescale, torch.Tensor) or rescale:
        dims = tuple(range(1, cond.ndim))
        std_c = cond.std(dim=dims, correction=0, keepdim=True)
        std_o = out.std(dim=dims, correction=0, keepdim=True)
        out = rescale * (out * (std_c / std_o.clamp_min(1e-8))) + keep * out
    if guidance_interval is not None and sigma is not None:
        lo, hi = guidance_interval
        if isinstance(sigma, torch.Tensor):
            out = torch.where((sigma >= lo) & (sigma <= hi), out, cond)
        elif not lo <= sigma <= hi:
            out = cond
    return out


def _as_f32(x, device) -> torch.Tensor:
    """A tensor or array-like as a float32 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


@dataclasses.dataclass(frozen=True)
class LoopSpec:
    """What fixes the operations of the step loop (a graph's key with the
    shapes and the route): the number of update steps, the prediction
    objective, the step's branch (`step`: "plain" DDIM / DPM++, "fresh"
    the fresh-noise re-noising, for fresh_noise=True and for eta = 1, one
    expression so that the two stay bit-equal, "eta" 0 < eta < 1, "heun"
    Heun's method), the block-caching interval (1 = off), whether
    guidance rescale and the guidance interval are on, whether an
    inpainting mask pins the keep region (`masked`) and the number of
    context channels a widened model takes after the latent's."""
    n_steps: int
    objective: str = "x0"
    step: str = "plain"
    cache_interval: int = 1
    rescale: bool = False
    interval: bool = False
    masked: bool = False
    context_channels: int = 0


def loop_scalars(eta: float = 0.0, cfg_rescale: float = 0.0,
                 guidance_interval=None) -> np.ndarray:
    """The options' values as `sample_loop` reads them: sqrt(1 - eta^2),
    eta, cfg_rescale, 1 - cfg_rescale, lo, hi; computed in float64 and
    rounded to float32 once (the JAX scan folds them as constants)."""
    lo, hi = guidance_interval if guidance_interval is not None else (0.0, 1.0)
    eta, r = float(eta), float(cfg_rescale)
    return np.array([math.sqrt(1.0 - eta * eta), eta, r, 1.0 - r, lo, hi],
                    dtype=np.float32)


def sample_loop(spec: LoopSpec, forward, x_init, labels_cat, levels, c1, c2,
                guidance, scalars, step_noise=None, mask=None, init=None,
                eps=None, context=None, forward_cached=None):
    """The step loop and the final extra denoise; returns the x0 estimate.

    forward(x2, noises, labels) -> prediction: one denoiser call on the
    CFG double batch. forward_cached(x2, noises, labels, delta, refresh)
    -> (prediction, delta): the block-cached call (spec.cache_interval >
    1). x_init (N, C, S, S) float32; labels_cat (2N, E): the labels, then
    the unconditional (or negative) ones; levels (n_steps + 1,), c1, c2
    (n_steps,), guidance (N,) and scalars (6,) (`loop_scalars`) float32; and
    with spec.step "fresh" or "eta" step_noise (n_steps, N, C, S, S).
    With spec.masked, mask (1 = generate, 0 = keep), init and eps (the
    initial noise), each (N, C, S, S): after each update the keep region
    is pinned to nxt eps + (1 - nxt) init, and the result is
    mask x0 + (1 - mask) init, so the keep region comes out equal to
    init. context (N, spec.context_channels, S, S): concatenated after
    x_t at every call, the same for both CFG halves (conditioning, not
    guided). Everything that varies between calls of one spec is a tensor
    (no input is written), so a captured graph of this function serves
    every value."""
    num = x_init.shape[0]
    sqrt_1m_eta2, eta, rescale, keep, lo, hi = scalars.unbind(0)

    def combine(pred, sigma):
        return cfg_combine(
            pred[:num], pred[num:], guidance, sigma,
            cfg_rescale=(rescale, keep) if spec.rescale else 0.0,
            guidance_interval=(lo, hi) if spec.interval else None)

    def call(x_t, sigma, cached=None):
        """The CFG double-batch call at level sigma -> the x0 estimate
        (and the block cache's delta)."""
        xin = x_t if context is None else torch.cat([x_t, context], dim=1)
        x2 = torch.cat([xin, xin], dim=0)
        noises = sigma.reshape(1, 1).expand(2 * num, 1).contiguous()
        if cached is None:
            pred = forward(x2, noises, labels_cat)
        else:
            pred, delta = forward_cached(x2, noises, labels_cat, *cached)
        x0 = prediction_to_x0(combine(pred, sigma), x_t, sigma,
                              spec.objective)
        return x0 if cached is None else (x0, delta)

    x_t = x_init
    x0_prev = torch.zeros_like(x_init)
    delta = None
    for i in range(spec.n_steps):
        curr, nxt, a, b = levels[i], levels[i + 1], c1[i], c2[i]
        if spec.step == "heun":
            # Heun on dx/ds = (x - x0(x, s)) / s: an Euler (DDIM) predictor
            # to the next level, a corrector there, the slopes averaged
            x0_a = call(x_t, curr)
            k1 = (x_t - x0_a) / curr
            x_e = x_t + (nxt - curr) * k1
            x0_b = call(x_e, nxt)
            k2 = (x_e - x0_b) / nxt
            x_t = x_t + (nxt - curr) * 0.5 * (k1 + k2)
            continue
        if spec.cache_interval > 1:
            # the refresh schedule is static: the host picks the branch
            x0, delta = call(x_t, curr,
                             (delta, i % spec.cache_interval == 0))
        else:
            x0 = call(x_t, curr)
        d = a * x0 + b * x0_prev
        if spec.step == "fresh":
            # re-noise the estimate to the next level with fresh noise
            x_t = nxt * step_noise[i] + (1.0 - nxt) * d
        elif spec.step == "eta":
            # eps_hat is the noise the state implies; mixing it with fresh
            # noise keeps the noise unit-variance (eta 0: DDIM, 1: fresh)
            eps_hat = (x_t - (1.0 - curr) * d) / curr
            mix = sqrt_1m_eta2 * eps_hat + eta * step_noise[i]
            x_t = nxt * mix + (1.0 - nxt) * d
        else:
            x_t = ((curr - nxt) * d + nxt * x_t) / curr
            if spec.masked:
                # the keep region back on the init's forward corruption
                x_keep = nxt * eps + (1.0 - nxt) * init
                x_t = mask * x_t + (1.0 - mask) * x_keep
        x0_prev = x0
    # final extra denoise at the last level
    x0 = call(x_t, levels[-1])
    return mask * x0 + (1.0 - mask) * init if spec.masked else x0


@dataclasses.dataclass
class SamplePlan:
    """One call's step loop: its graph key, spec, denoiser calls and input
    tensors."""
    key: Tuple
    spec: LoopSpec
    forward: Callable
    forward_cached: Optional[Callable]
    inputs: Dict[str, torch.Tensor]

    @torch.no_grad()
    def run_eager(self) -> torch.Tensor:
        return sample_loop(self.spec, self.forward, **self.inputs,
                           forward_cached=self.forward_cached)


class DiffusionGenerator:
    """Reverse-diffusion generator over a denoiser and an optional VAE.

    model: the plain `Denoiser` (its parameters are what the fused engine
    packs). fast_apply: an engine with `prepare(state_dict)` and
    `apply_prepared(prepared, x, noise_level, label)` (the fused engine;
    with `apply_prepared_cached` and `cache_span` it also runs block
    caching), which runs the model on grids of at most 16 x 16 tokens at
    the native size, as the JAX package gates it
    (sampling/diffusion.py:304-334); otherwise, or with None, `model`
    itself runs. vae: an object with `decode(latents_nchw)`, or None to
    return latents only. device: where sampling runs, a required keyword
    ("cuda" or "cpu"), as for `DiffusionTransformer`. pos_resize: on a
    grid other than the model's native one, None (the default)
    bilinear-resizes the learned positional table onto it
    (`resize_pos_embed`); False takes its first h*w rows (smaller grids
    only), as in the JAX package.

    The engine's packed weights and the resized table are kept while the
    model's parameters stay as they are (the same tensors at the same
    versions); any change to them, such as a `load_state_dict`, packs
    again and drops the captured graphs. On CUDA the first call for a key
    (`SamplePlan.key`) runs the step loop eagerly, the second captures it
    into a CUDA graph, and later calls replay it (`sampling/graph.py`).
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
        self.graphs = LoopGraphs()
        self._weights: Tuple = (None, {})  # (parameter versions, packed)

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

    def _check_weights(self) -> None:
        """Drop every packed item and captured graph when the model's
        parameters and buffers are no longer the same tensors at the same
        versions (a `load_state_dict`, an optimizer step, a replaced
        parameter): a graph reads the weights by address."""
        versions = tuple((t.data_ptr(), t._version) for t in itertools.chain(
            self.model.parameters(), self.model.buffers()))
        if self._weights[0] != versions:
            self.graphs.clear()
            self._weights = (versions, {})

    def _packed(self, what, make: Callable):
        """`make()` (weights packed from the model's), kept until
        `_check_weights` finds the model's weights changed."""
        packed = self._weights[1]
        if what not in packed:
            packed[what] = make()
        return packed[what]

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
    def plan_loop(
        self,
        labels,
        n_iter: int = 30,
        num_imgs: int = 16,
        class_guidance: float = 3,
        seed: int = 10,
        img_size: int = 32,
        exponent: float = 1,
        seeds=None,
        noise_levels=None,
        use_ddpm_plus: bool = True,
        cache_interval: int = 1,
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
    ) -> SamplePlan:
        """Check the options as the JAX generator does and build the step
        loop of one `generate` call (its arguments, less the output ones)."""
        if sampler is None:
            sampler = "dpm" if use_ddpm_plus else "ddim"
        if sampler not in ("ddim", "dpm", "heun"):
            raise ValueError(f"unknown sampler {sampler!r}; expected "
                             f"'ddim', 'dpm' or 'heun'")
        use_ddpm_plus = sampler == "dpm"
        heun = sampler == "heun"
        if heun:
            if mask is not None:
                raise ValueError("sampler='heun' does not compose with "
                                 "inpainting (use ddim/dpm)")
            if fresh_noise:
                raise ValueError("fresh_noise is its own (consistency-"
                                 "multistep) update; it excludes "
                                 "sampler='heun'")
            if cache_interval > 1:
                raise ValueError("cache_interval > 1 (block caching) "
                                 "assumes the DDIM/DPM scan body; it "
                                 "excludes sampler='heun'")
        eta = float(eta)
        if not 0.0 <= eta <= 1.0:
            raise ValueError(f"eta must be in [0, 1], got {eta}")
        if eta:
            if use_ddpm_plus or heun:
                raise ValueError(
                    "eta > 0 (stochastic DDIM) requires the DDIM update "
                    "— pass sampler='ddim' or use_ddpm_plus=False (the "
                    "DPM++/heun multistep history assumes a "
                    "deterministic trajectory)")
            if fresh_noise:
                raise ValueError("fresh_noise IS eta=1; pass one or the "
                                 "other")
            if mask is not None:
                raise ValueError("eta > 0 does not compose with "
                                 "inpainting (the keep-region pinning "
                                 "assumes the deterministic DDIM update)")
        if init_latents is not None and not 0.0 < strength <= 1.0:
            raise ValueError(f"strength must be in (0, 1], got {strength}")
        if mask is not None and init_latents is None:
            raise ValueError("mask requires init_latents (inpainting is "
                             "masked img2img)")
        if fresh_noise:
            if mask is not None:
                raise ValueError("fresh_noise does not compose with "
                                 "inpainting (the keep-region pinning "
                                 "assumes the deterministic DDIM update)")
            if use_ddpm_plus:
                raise ValueError("fresh_noise replaces the deterministic "
                                 "update entirely; pass use_ddpm_plus="
                                 "False (the DPM++ multistep history is "
                                 "meaningless across re-noising)")
        n_ch = self.model.n_channels
        in_ch = getattr(self.model, "input_channels", None) or n_ch
        if context_latents is not None and in_ch <= n_ch:
            raise ValueError(
                "context_latents requires a widened-input model "
                "(DenoiserConfig.input_channels > n_channels)")
        if not 0.0 <= cfg_rescale <= 1.0:
            raise ValueError(f"cfg_rescale must be in [0, 1], got "
                             f"{cfg_rescale}")
        if guidance_interval is not None:
            lo, hi = guidance_interval
            if not 0.0 <= lo <= hi <= 1.0:
                raise ValueError(f"guidance_interval must satisfy 0 <= lo "
                                 f"<= hi <= 1, got {guidance_interval}")
            guidance_interval = (float(lo), float(hi))

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
        if init_latents is not None:
            # skip the first (1 - strength) of the schedule; start from the
            # corruption of init at the first level left
            n_skip = min(int(round((1.0 - strength) * (len(noise_levels) - 1))),
                         len(noise_levels) - 2)
            noise_levels = noise_levels[n_skip:]
        c1, c2 = make_step_coeffs(noise_levels, use_ddpm_plus)
        n_steps = len(noise_levels) - 1

        pred_kind = self.prediction_type or str(
            getattr(self.model, "objective", "x0"))
        if pred_kind not in PREDICTION_OBJECTIVES:
            raise ValueError(f"unknown prediction_type {pred_kind!r}")

        dev = self.device
        noise = self.initialize_image(seeds, num_imgs, img_size, seed)
        x_init, init = noise, None
        if init_latents is not None:
            # a (1, C, S, S) init broadcasts over the images
            init = _as_f32(init_latents, dev).expand_as(noise).contiguous()
            sigma0 = float(noise_levels[0])
            x_init = sigma0 * noise + (1.0 - sigma0) * init
        labels = _as_f32(labels, dev)
        uncond = (torch.zeros_like(labels) if negative_labels is None
                  else _as_f32(negative_labels, dev).expand_as(labels))
        labels_cat = torch.cat([labels, uncond], dim=0)
        guidance = _as_f32(class_guidance, dev).expand(num_imgs).contiguous()

        size = x_init.shape[-1]
        self._check_weights()
        engine = self.fast_apply if self.uses_engine(size) else None
        resize_grid = self._resize_grid(size)
        forward_cached = None
        if engine is not None:
            prepared = self._packed("engine", lambda: engine.prepare(
                self.model.state_dict()))

            def forward(x2, noises, labels):
                return engine.apply_prepared(prepared, x2, noises, labels)

            if hasattr(engine, "apply_prepared_cached"):
                def forward_cached(x2, noises, labels, delta, refresh):
                    return engine.apply_prepared_cached(
                        prepared, x2, noises, labels, delta, refresh)
            route = ("engine", getattr(engine, "quantize", None))
        elif resize_grid is not None:
            model = self.model  # not self: a captured graph holds forward
            pos = self._packed(("pos", resize_grid), lambda: resize_pos_embed(
                model.denoiser_trans_block.pos_embed.weight,
                model.image_size // model.patch_size, resize_grid))

            def forward(x2, noises, labels):
                return model(x2, noises, labels, pos_embed_override=pos)

            route = ("linen", resize_grid)
        else:
            forward = self.model
            route = ("linen", None)

        if fresh_noise or eta or mask is not None:
            cache_interval = 1  # block caching: plain DDIM/DPM loops only
        if cache_interval > 1 and forward_cached is None:
            warnings.warn(
                "cache_interval > 1 requires the fused engine (fast_apply "
                "with apply_prepared_cached) and <= 256 tokens; falling "
                "back to exact sampling", stacklevel=3)
            cache_interval = 1
        step = ("heun" if heun else "fresh" if fresh_noise or eta == 1.0
                else "eta" if eta else "plain")
        spec = LoopSpec(n_steps=n_steps, objective=pred_kind, step=step,
                        cache_interval=max(int(cache_interval), 1),
                        rescale=bool(cfg_rescale),
                        interval=guidance_interval is not None,
                        masked=mask is not None,
                        context_channels=in_ch - n_ch)
        inputs = {
            "x_init": x_init, "labels_cat": labels_cat,
            "levels": _as_f32(noise_levels, dev), "c1": _as_f32(c1, dev),
            "c2": _as_f32(c2, dev), "guidance": guidance,
            "scalars": torch.from_numpy(loop_scalars(
                eta, cfg_rescale, guidance_interval)).to(dev),
        }
        if mask is not None:
            inputs.update(mask=_as_f32(mask, dev).expand_as(noise).contiguous(),
                          init=init, eps=noise)
        if in_ch > n_ch:
            # a widened model without context gets zeros ("fully unknown")
            extra = (noise.shape[0], in_ch - n_ch, *noise.shape[2:])
            inputs["context"] = (
                torch.zeros(extra, device=dev) if context_latents is None
                else _as_f32(context_latents, dev).expand(extra).contiguous())
        if step in ("fresh", "eta"):
            if fresh_noise_keys is None:
                fresh_noise_keys = fresh_noise_image_seeds(seed, num_imgs)
            elif len(fresh_noise_keys) != num_imgs:
                raise ValueError(f"fresh_noise_keys carries "
                                 f"{len(fresh_noise_keys)} keys for "
                                 f"{num_imgs} images")
            inputs["step_noise"] = draw_step_noise(
                fresh_noise_keys, n_steps, x_init.shape[1:]).to(dev)
        key = (route, tuple(x_init.shape), tuple(labels_cat.shape), spec)
        return SamplePlan(key, spec, forward, forward_cached, inputs)

    @torch.no_grad()
    def run_plan(self, plan: SamplePlan) -> torch.Tensor:
        """The plan's x0 estimate: on CUDA through the captured graph of its
        key (captured at the key's first call), on the CPU eagerly."""
        if self.device.type != "cuda":
            return plan.run_eager()
        # a captured graph keeps `loop`: it holds the denoiser calls (and so
        # the weights the graph reads), not the plan's inputs
        spec, forward, forward_cached = (plan.spec, plan.forward,
                                         plan.forward_cached)

        def loop(**inputs):
            return sample_loop(spec, forward, **inputs,
                               forward_cached=forward_cached)

        return self.graphs.run(plan.key, loop, plan.inputs)

    @torch.no_grad()
    def generate(self, labels, *, scale_factor: float = 8,
                 sharp_f: float = 0.1, bright_f: float = 0.1,
                 output: str = "float", **kw):
        """Generate images by reverse diffusion.

        Returns (images, x0 latents (N, C, S, S) float32): images are
        (N, 3, H, W) float, or (N, H, W, 3) uint8 with output="uint8"
        (clip((x+1)/2) * 255 + 0.5, truncated), or None without a VAE.
        sharp_f and bright_f shift latent channels 3 and 0 before the
        decode of x0 * scale_factor (under a mask, only where it is 1, so
        the keep region stays equal to init_latents).

        The other keywords are `plan_loop`'s, the JAX generator's options:
        sampler "ddim", "dpm" or "heun"; eta in [0, 1] (stochastic DDIM)
        and fresh_noise, with per-image noise streams
        (`fresh_noise_image_seeds`; pass `fresh_noise_keys`, one seed per
        image, to set them); cfg_rescale and guidance_interval;
        cache_interval > 1, block caching on the fused engine; negative
        labels, explicit initial noise (`seeds`), the three noise schedules
        and a schedule shift; and the editing options: init_latents
        (sampler units, (N or 1, C, S, S)) with strength in (0, 1]
        (img2img: the first round((1 - strength) (len - 1)) levels are
        skipped, the loop starts at s0 noise + (1 - s0) init), mask
        (inpainting, broadcastable to the latents, 1 = generate; DDIM or
        DPM++ only) and context_latents (a widened model's extra input
        channels, zeros when not given)."""
        if output not in ("float", "uint8"):
            raise ValueError(f"unknown output {output!r}")
        plan = self.plan_loop(labels, **kw)
        x0 = self.run_plan(plan)
        mask = plan.inputs.get("mask")
        shift = 1.0 if mask is None else mask[:, 0]
        x0[:, 3] += sharp_f * shift
        x0[:, 0] += bright_f * shift
        if self.vae is None:
            return None, x0
        img = self.vae.decode(x0 * scale_factor)
        if output == "uint8":
            u = torch.clamp((img.float() + 1.0) * 0.5, 0.0, 1.0) * 255.0 + 0.5
            img = u.permute(0, 2, 3, 1).to(torch.uint8)
        return img, x0
