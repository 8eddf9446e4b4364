"""The pipeline: the port's `DiffusionTransformer`.

Counterpart of the JAX package's `sampling/pipeline.py` less best-of-N:
build the denoiser, the VAE (both halves) and the CLIP text tower from an
`LTDConfig` on an explicit device, with weights from the configured files
or seeded random weights, and expose text-to-image
(`generate_image_from_text`, a PIL grid; `generate_array_from_text`,
(N, H, W, 3) uint8) and image editing: `image_to_image` (img2img),
`inpaint`, `outpaint` (a widened-input model) and `interpolate` (slerped
prompts and/or initial noise). Editing runs at the model's native size,
so on CUDA through the same fused engine as text-to-image.

On a CUDA device the denoiser runs the hand-written kernels, as the JAX
package runs its Pallas kernels on the TPU (sampling/pipeline.py:113-131,
225-237), in the configured compute dtype: float32, the default of
`DenoiserLoad`, runs the kernels' float32 bodies
(`ops/fused_stack_f32.py`), bfloat16 their bf16 ones: grids of at most 16 x 16 tokens at the native size go through
the fused engine (K1); larger grids (512 and 1024 px deployments, or a
256 px model sampled on a larger grid) through the `Denoiser`'s linen path
with flash attention (K3) in every self-attention and, for a native grid
of 16 < hw <= 32 tokens a side, the fused sep-conv MLP (K5's forward).
`LTDConfig.quantize="int8"` builds the W8A8 engine (K7) instead of K1's,
behind the same gate, so a hi-res int8 deployment runs K3/K5 and no K7,
as in JAX. The engines pack the sep-conv layer: a model with the "mlp" or
"moe" FFN runs the linen path on every grid, flash attention (K3) in
every self-attention and its FFN in plain PyTorch, and `quantize` has no
effect on it. On the CPU it runs the plain `Denoiser`, as the JAX package
does off the TPU: no engine, so `quantize` has no effect there
(sampling/pipeline.py:225-237).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from transformer_latent_diffusion_tpu_torch.configs import LTDConfig, resolve_dtype
from transformer_latent_diffusion_tpu_torch.models.clip import (
    ClipTextModel,
    make_tokenizer,
)
from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import (
    QUANTIZE_MODES,
    make_fused_apply,
)
from transformer_latent_diffusion_tpu_torch.models.vae import AutoencoderKL
from transformer_latent_diffusion_tpu_torch.sampling.diffusion import (
    DiffusionGenerator,
)
from transformer_latent_diffusion_tpu_torch.utils.common import (
    init_random_weights_,
    load_state_dict_file,
    slerp,
    uint8_grid_to_pil,
)

# LTDConfig fields the port does not run yet: field -> (default, ROADMAP item)
_NOT_PORTED = {
    "mesh_shape": (None, "item 14 (parallelism)"),
    "sequence_parallel": (None, "item 14 (parallelism)"),
    "pipeline_parallel": (False, "item 14 (parallelism)"),
    "pipeline_microbatches": (None, "item 14 (parallelism)"),
    "lora_path": (None, "item 11 (fine-tune variants)"),
    "lora_scale": (None, "item 11 (fine-tune variants)"),
    "consistency": (False, "item 11 (fine-tune variants)"),
    "clip_vision_cfg": (None, "item 12 (eval towers)"),
}


def pool_mask_to_latent(mask, want: int) -> np.ndarray:
    """Image-space inpainting mask -> (1, 1, S, S) latent-grid mask (the
    JAX package's function): nonzero = regenerate, zero = keep; a
    multi-channel mask uses its first channel; max-pooled to the latent
    grid, so any touched latent cell regenerates."""
    m = np.asarray(mask, dtype=np.float32)
    if m.ndim == 3:  # RGB(A)/channel-last mask -> first channel
        m = m[..., 0]
    m = (m > 0).astype(np.float32)
    down = m.shape[-1] // want
    if down < 1 or m.shape[-1] != want * down or m.shape[-2] != want * down:
        raise ValueError(
            f"mask is {m.shape[-2]}x{m.shape[-1]}; expected a square "
            f"multiple of the {want}-wide latent grid")
    m = m.reshape(want, down, want, down).max(axis=(1, 3))
    return m[None, None]  # (1,1,S,S) broadcasts over batch+channels


def _load_or_init(module, path, seed: int, kind: str, keep=None, cfg=None):
    """Weights of the `kind` tower from `path` when it exists, in any
    format `load_state_dict_file` reads (keys filtered by `keep`, then a
    strict load), else seeded random weights."""
    if path and os.path.exists(path):
        sd = load_state_dict_file(path, kind, cfg)
        if keep is not None:
            sd = {k: v for k, v in sd.items() if keep(k)}
        module.load_state_dict(sd)
        return module
    print(f"{type(module).__name__}: no weights file — random weights from "
          f"seed {seed}")
    return init_random_weights_(module, seed)


def denoiser_kernel_flags(cfg: LTDConfig, device) -> dict:
    """The `Denoiser` flags of the linen path on `device`: on CUDA flash
    attention everywhere (use_pallas) and the fused sep-conv MLP for a
    native grid of 16 < hw <= 32 (the JAX package's hybrid regime); on the
    CPU `cfg.use_pallas` (the plain versions either way) and no fused MLP,
    as the JAX package off the TPU."""
    den = cfg.denoiser_cfg
    hw = den.image_size // den.patch_size
    on_cuda = torch.device(device).type == "cuda"
    return {"use_pallas": bool(cfg.use_pallas),
            "fused_mlp_vjp": bool(on_cuda and cfg.use_pallas and 16 < hw <= 32
                                  and den.mlp_class == "sep_conv")}


def uses_fused_engine(cfg: LTDConfig, device) -> bool:
    """Whether the deployment builds a fused engine (K1's, or K7's with
    quantize="int8"): on CUDA for the sep-conv FFN, whose layer the
    engines pack (JAX sampling/pipeline.py:225-237). The "mlp" and "moe"
    FFNs take the linen path, with flash attention (K3)."""
    return (torch.device(device).type == "cuda"
            and cfg.denoiser_cfg.mlp_class == "sep_conv")


class DiffusionTransformer:
    """cfg: the inference config; device: where every tower runs ("cuda",
    "cuda:0", "cpu"); seed: the seed of the random weights of any tower
    without a weights file."""

    def __init__(self, cfg: LTDConfig, device, seed: int = 0):
        for name, (default, item) in _NOT_PORTED.items():
            if getattr(cfg, name) != default:
                raise NotImplementedError(
                    f"LTDConfig.{name} is not ported yet (ROADMAP {item})")
        if cfg.quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode: {cfg.quantize!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        dtype = resolve_dtype(cfg.denoiser_load.dtype)
        if self.device.type == "cuda" and not cfg.use_pallas:
            raise NotImplementedError(
                "LTDConfig.use_pallas=False: the port has no switch off its "
                "kernels; on CUDA the denoiser always runs them (the plain "
                "versions serve the CPU only)")
        if self.device.type == "cuda" and dtype not in (torch.bfloat16,
                                                        torch.float32):
            raise NotImplementedError(
                f"DenoiserLoad.dtype={cfg.denoiser_load.dtype!r}: on CUDA the "
                "denoiser's kernels take bf16 or float32 weights, so set "
                "DenoiserLoad.dtype to 'bfloat16' or 'float32' (other "
                "compute dtypes on CUDA are ROADMAP item 4)")
        den_cfg = cfg.denoiser_cfg
        if (self.device.type == "cuda" and dtype == torch.float32
                and not (uses_fused_engine(cfg, self.device)
                         and den_cfg.image_size // den_cfg.patch_size <= 16)):
            raise NotImplementedError(
                "DenoiserLoad.dtype='float32' on CUDA runs the fused engine's "
                "float32 bodies (a sep-conv model of at most 16 x 16 tokens); "
                "the linen path's kernels (flash attention, the fused MLP) "
                "take bf16, so set DenoiserLoad.dtype='bfloat16' (their "
                "float32 bodies are ROADMAP item 4)")

        load = cfg.denoiser_load
        if load.file_url is not None and not (
                load.local_filename and os.path.exists(load.local_filename)):
            raise NotImplementedError(
                "downloading denoiser weights is not ported; fetch "
                f"{load.file_url} to DenoiserLoad.local_filename")
        denoiser = Denoiser.from_config(
            cfg.denoiser_cfg, dtype=dtype,
            **denoiser_kernel_flags(cfg, self.device))
        _load_or_init(denoiser, load.local_filename, seed, "denoiser",
                      cfg=cfg.denoiser_cfg)
        denoiser.to(self.device).eval()

        self.vae = AutoencoderKL.from_config(cfg.vae_cfg)
        _load_or_init(self.vae, cfg.vae_cfg.weights_path, seed + 1, "vae",
                      keep=lambda k: k.startswith(("decoder.", "encoder.",
                                                   "post_quant_conv.",
                                                   "quant_conv.")))
        self.vae.to(self.device, resolve_dtype(cfg.vae_cfg.vae_dtype)).eval()

        self.clip_model = ClipTextModel.from_config(
            cfg.clip_cfg, dtype=resolve_dtype(cfg.clip_cfg.clip_dtype))
        text_keys = set(self.clip_model.state_dict())
        _load_or_init(self.clip_model, cfg.clip_cfg.weights_path, seed + 2, "clip",
                      keep=text_keys.__contains__)
        self.clip_model.to(self.device).eval()
        clip_file = cfg.clip_cfg.weights_path
        self.tokenizer = make_tokenizer(
            cfg.clip_cfg.vocab_path,
            real_weights=bool(clip_file and os.path.exists(clip_file)))

        fast_apply = None
        if uses_fused_engine(cfg, self.device):
            fast_apply = make_fused_apply(cfg.denoiser_cfg, compute_dtype=dtype,
                                          quantize=cfg.quantize)
        self.schedule_shift = cfg.schedule_shift
        if self.schedule_shift is not None:
            self.schedule_shift = float(self.schedule_shift)
            if self.schedule_shift <= 0.0:
                raise ValueError("LTDConfig.schedule_shift must be > 0, "
                                 f"got {self.schedule_shift}")
        self.diffuser = DiffusionGenerator(
            model=denoiser, vae=self.vae, fast_apply=fast_apply,
            device=self.device)
        self._scale_factor = float(cfg.vae_cfg.vae_scale_factor)

    @staticmethod
    def _resolve_pad(pad_to, num_imgs: int) -> int:
        """Generation batch size: `pad_to` >= num_imgs images are generated
        and the first num_imgs returned (one batch shape per bucket)."""
        if pad_to is None:
            return num_imgs
        p = int(pad_to)
        if p < num_imgs:
            raise ValueError(f"pad_to={p} is smaller than num_imgs={num_imgs}")
        return p

    def _encode_prompts(self, prompt, negative_prompt, num_imgs):
        prompts = (list(prompt) if isinstance(prompt, (list, tuple))
                   else [prompt] * num_imgs)
        labels = self.clip_model.encode_text(prompts, self.tokenizer)
        negative_labels = None
        if negative_prompt is not None:
            negative_labels = self.clip_model.encode_text(
                [negative_prompt] * num_imgs, self.tokenizer)
        return labels, negative_labels

    def generate_image_from_text(self, prompt, class_guidance=6, seed=11,
                                 num_imgs=1, img_size=32, n_iter=15,
                                 cache_interval=1, negative_prompt=None,
                                 pad_to=None, cfg_rescale=0.0,
                                 guidance_interval=None, sampler=None,
                                 schedule="poly", eta=0.0,
                                 schedule_shift=None):
        """Prompt -> PIL image grid. The latent size comes from the model's
        image_size; `img_size` is accepted and unused, as in the
        reference. A list of prompts gives one image per prompt."""
        num_imgs = len(prompt) if isinstance(prompt, (list, tuple)) \
            else num_imgs
        out = self.generate_array_from_text(
            prompt, class_guidance=class_guidance, seed=seed,
            num_imgs=num_imgs, n_iter=n_iter, cache_interval=cache_interval,
            negative_prompt=negative_prompt, pad_to=pad_to,
            cfg_rescale=cfg_rescale, guidance_interval=guidance_interval,
            sampler=sampler, schedule=schedule, eta=eta,
            schedule_shift=schedule_shift)
        return uint8_grid_to_pil(out, nrow=int(math.sqrt(num_imgs)), padding=4)

    def generate_array_from_text(self, prompt, class_guidance=6, seed=11,
                                 num_imgs=1, n_iter=15, cache_interval=1,
                                 negative_prompt=None, pad_to=None,
                                 cfg_rescale=0.0, guidance_interval=None,
                                 sampler=None, schedule="poly", eta=0.0,
                                 schedule_shift=None) -> np.ndarray:
        """Like generate_image_from_text, but returns the images as a
        (num_imgs, H, W, 3) uint8 array."""
        if isinstance(prompt, (list, tuple)):
            prompts = list(prompt)
            num_imgs = len(prompts)
        else:
            prompts = [prompt] * num_imgs
        gen_n = self._resolve_pad(pad_to, num_imgs)
        prompts = prompts + [prompts[-1]] * (gen_n - num_imgs)
        labels, negative_labels = self._encode_prompts(
            prompts, negative_prompt, gen_n)
        if schedule_shift is None:
            schedule_shift = self.schedule_shift
        out, _ = self.diffuser.generate(
            labels=labels, num_imgs=gen_n,
            img_size=self.diffuser.model.image_size,
            class_guidance=class_guidance, seed=seed, n_iter=n_iter,
            exponent=1, scale_factor=self._scale_factor, sharp_f=0,
            bright_f=0, cache_interval=cache_interval, output="uint8",
            negative_labels=negative_labels, cfg_rescale=cfg_rescale,
            guidance_interval=guidance_interval, sampler=sampler,
            schedule=schedule, eta=eta, schedule_shift=schedule_shift)
        return out[:num_imgs].cpu().numpy()

    # ------------------------------ editing ------------------------------

    def _encode_init_image(self, image) -> torch.Tensor:
        """PIL / (H, W, 3) / (B, H, W, 3) image -> sampler-unit latents
        (B, C, S, S) float32 on the device. Integer inputs are uint8 pixels
        rescaled to [-1, 1]; float inputs are taken as [-1, 1] (decided by
        the dtype, not the value range)."""
        raw = np.asarray(image)
        is_int = np.issubdtype(raw.dtype, np.integer)
        arr = raw.astype(np.float32)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.shape[-1] == 3:  # HWC -> CHW
            arr = np.transpose(arr, (0, 3, 1, 2))
        if is_int:
            arr = arr / 127.5 - 1.0
        img = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        lat = self.vae.encode(img) / self._scale_factor
        want = self.diffuser.model.image_size
        if tuple(lat.shape[-2:]) != (want, want):  # non-square must fail too
            down = arr.shape[-1] // lat.shape[-1]  # this VAE's spatial factor
            raise ValueError(
                f"input image is {arr.shape[-2]}x{arr.shape[-1]}px -> latent "
                f"{lat.shape[-2]}x{lat.shape[-1]}, but the model expects a "
                f"square {want} latent ({want * down}px with this VAE); "
                f"resize the image first")
        return lat

    def _edit(self, lat, prompt, num_imgs, pad_to, negative_prompt, **kw):
        """img2img / inpainting from the latents `lat`: one variation per
        input image, or num_imgs of a single one; returns the PIL grid."""
        if not (lat.shape[0] == 1 and num_imgs > 1):
            # (1, C, S, S) broadcasts against num_imgs noise draws; a real
            # batch fixes num_imgs to the batch size
            num_imgs = int(lat.shape[0])
        gen_n = self._resolve_pad(pad_to, num_imgs)
        if gen_n > num_imgs and lat.shape[0] > 1:
            lat = torch.cat([lat, lat[-1:].expand(gen_n - num_imgs, -1, -1, -1)])
        labels, negative_labels = self._encode_prompts(
            prompt, negative_prompt, gen_n)
        out, _ = self.diffuser.generate(
            labels=labels, num_imgs=gen_n,
            img_size=self.diffuser.model.image_size, exponent=1,
            scale_factor=self._scale_factor, sharp_f=0, bright_f=0,
            output="uint8", negative_labels=negative_labels, init_latents=lat,
            **kw)
        return uint8_grid_to_pil(out[:num_imgs].cpu().numpy(),
                                 nrow=int(math.sqrt(num_imgs)), padding=4)

    def image_to_image(self, image, prompt: str, strength: float = 0.5,
                       class_guidance=6, seed=11, num_imgs=1, n_iter=15,
                       negative_prompt=None, pad_to=None):
        """Image + prompt -> PIL grid (img2img). `image` is a PIL image or
        an (H, W, 3) / (B, H, W, 3) uint8 or float ([-1, 1]) array at the
        model's pixel size; it is VAE-encoded and re-noised to the
        schedule's `strength` point, then denoised under the prompt. One
        input image with num_imgs > 1 gives num_imgs variations."""
        return self._edit(self._encode_init_image(image), prompt, num_imgs,
                          pad_to, negative_prompt,
                          class_guidance=class_guidance, seed=seed,
                          n_iter=n_iter, strength=strength)

    def inpaint(self, image, mask, prompt: str, strength: float = 1.0,
                class_guidance=6, seed=11, num_imgs=1, n_iter=15,
                negative_prompt=None, pad_to=None):
        """Regenerate the masked region of `image` under `prompt`. `mask`
        is a PIL image or (H, W) array in image space, nonzero =
        regenerate (see `pool_mask_to_latent`); the keep region's latents
        come out equal to the encoded image's. strength < 1 also limits
        how far the masked region departs."""
        lat = self._encode_init_image(image)
        m = pool_mask_to_latent(mask, self.diffuser.model.image_size)
        return self._edit(lat, prompt, num_imgs, pad_to, negative_prompt,
                          class_guidance=class_guidance, seed=seed,
                          n_iter=n_iter, strength=strength, mask=m)

    def outpaint(self, image, prompt: str, n_tiles: int = 1,
                 direction: str = "right", overlap: float = 0.5,
                 class_guidance=6, seed=11, n_iter=15, negative_prompt=None):
        """Extend `image` by `n_tiles` model-sized tiles toward `direction`
        with a widened-input model (input_channels == 2 * n_channels, e.g.
        `expand_input_channels` then `TrainConfig.outpaint`). Each tile's
        context channels hold the `overlap` fraction of the previous tile's
        x0 at the seam (zeros elsewhere); one `generate` a tile. The
        panorama keeps the input's pixels and appends each tile's part
        past the seam. Returns a PIL image."""
        from PIL import Image

        model = self.diffuser.model
        if (model.input_channels or model.n_channels) <= model.n_channels:
            raise ValueError(
                "outpaint requires a widened-input model "
                "(DenoiserConfig.input_channels == 2*n_channels); expand "
                "a trained checkpoint with "
                "models.denoiser.expand_input_channels and fine-tune")
        if direction not in ("right", "left", "down", "up"):
            raise ValueError(f"unknown direction {direction!r}")
        s = model.image_size
        k = int(round(overlap * s))
        if not 0 < k < s:
            raise ValueError(
                f"overlap={overlap} must leave 0 < overlap < 1 of the "
                f"{s}-wide latent grid shared across the seam")
        axis = -1 if direction in ("right", "left") else -2
        at_end = direction in ("right", "down")  # seam side of the last tile

        prev = self._encode_init_image(image)
        if prev.shape[0] != 1:
            raise ValueError("outpaint takes a single image")
        labels, negative_labels = self._encode_prompts(
            prompt, negative_prompt, 1)
        # the canvas keeps the input's pixels, not a VAE round trip
        raw = np.asarray(image)
        if raw.ndim == 4:
            raw = raw[0]
        if np.issubdtype(raw.dtype, np.integer):
            pan = raw.astype(np.uint8)
        else:
            pan = ((np.clip(raw, -1.0, 1.0) + 1.0) * 127.5 + 0.5).astype(np.uint8)
        k_px = k * (pan.shape[0] // s)
        pix_axis = 1 if axis == -1 else 0
        for i in range(n_tiles):
            ctx = torch.zeros_like(prev)
            src = [slice(None)] * prev.ndim
            dst = [slice(None)] * prev.ndim
            # the new tile's seam-facing edge sees prev's opposite edge
            src[axis] = slice(-k, None) if at_end else slice(0, k)
            dst[axis] = slice(0, k) if at_end else slice(-k, None)
            ctx[tuple(dst)] = prev[tuple(src)]
            img_u8, prev = self.diffuser.generate(
                labels=labels, num_imgs=1, img_size=s,
                class_guidance=class_guidance, seed=seed + i, n_iter=n_iter,
                exponent=1, scale_factor=self._scale_factor, sharp_f=0,
                bright_f=0, output="uint8", negative_labels=negative_labels,
                context_latents=ctx)
            tile = img_u8[0].cpu().numpy()
            keep = [slice(None)] * 3
            keep[pix_axis] = (slice(k_px, None) if at_end
                              else slice(0, tile.shape[pix_axis] - k_px))
            pieces = ([pan, tile[tuple(keep)]] if at_end
                      else [tile[tuple(keep)], pan])
            pan = np.concatenate(pieces, axis=pix_axis)
        return Image.fromarray(pan)

    def interpolate(self, prompt_a: str, prompt_b=None, n_frames: int = 8,
                    class_guidance=6, seed=11, seed_b=None, n_iter=15,
                    negative_prompt=None):
        """An interpolation strip, frame 0 = (prompt_a, seed), the last =
        (prompt_b, seed_b): prompt_b slerps the two pooled CLIP embeddings,
        seed_b the two seeds' initial noise (either or both; the other
        axis stays fixed). All frames run in one sampler call. Returns a
        one-row PIL strip."""
        if n_frames < 2:
            raise ValueError(f"n_frames must be >= 2, got {n_frames}")
        if prompt_b is None and seed_b is None:
            raise ValueError("nothing to interpolate: give prompt_b "
                             "and/or seed_b")

        def embed(prompts):
            return self.clip_model.encode_text(
                prompts, self.tokenizer).detach().float().cpu().numpy()

        ts = np.linspace(0.0, 1.0, n_frames)
        if prompt_b is not None:
            emb = embed([prompt_a, prompt_b])
            labels = slerp(emb[0], emb[1], ts)
        else:
            la = embed([prompt_a])
            labels = np.broadcast_to(la[0], (n_frames, la.shape[-1]))
        negative_labels = (None if negative_prompt is None
                           else embed([negative_prompt] * n_frames))
        size = self.diffuser.model.image_size
        noise = self.diffuser.initialize_image(None, 1, size, seed).cpu().numpy()
        if seed_b is not None:
            noise_b = self.diffuser.initialize_image(
                None, 1, size, seed_b).cpu().numpy()
            seeds = slerp(noise.ravel(), noise_b.ravel(), ts).reshape(
                (n_frames,) + noise.shape[1:])
        else:
            seeds = np.broadcast_to(noise, (n_frames,) + noise.shape[1:])
        out, _ = self.diffuser.generate(
            labels=labels, num_imgs=n_frames, img_size=size,
            class_guidance=class_guidance, seed=seed, seeds=seeds,
            n_iter=n_iter, exponent=1, scale_factor=self._scale_factor,
            sharp_f=0, bright_f=0, output="uint8",
            negative_labels=negative_labels)
        return uint8_grid_to_pil(out.cpu().numpy(), nrow=n_frames, padding=4)
