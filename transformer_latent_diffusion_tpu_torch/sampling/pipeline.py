"""Text-to-image pipeline: the port's `DiffusionTransformer`.

Counterpart of the text-to-image part of the JAX package's
`sampling/pipeline.py`: build the denoiser, VAE decoder and CLIP text
tower from an `LTDConfig` on an explicit device, with weights from the
configured files or seeded random weights, and expose
`generate_image_from_text` (a PIL grid) and `generate_array_from_text`
((N, H, W, 3) uint8).

On a CUDA device the denoiser runs the hand-written kernels, as the JAX
package runs its Pallas kernels on the TPU (sampling/pipeline.py:113-131,
225-237): grids of at most 16 x 16 tokens at the native size go through
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
from transformer_latent_diffusion_tpu_torch.models.vae import VaeDecoder
from transformer_latent_diffusion_tpu_torch.sampling.diffusion import (
    DiffusionGenerator,
)
from transformer_latent_diffusion_tpu_torch.utils.common import (
    init_random_weights_,
    load_state_dict_file,
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


def _load_or_init(module, path, seed: int, keep=None):
    """Weights from `path` when it exists (keys filtered by `keep`, then a
    strict load), else seeded random weights."""
    if path and os.path.exists(path):
        sd = load_state_dict_file(path)
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
        if self.device.type == "cuda" and dtype != torch.bfloat16:
            raise NotImplementedError(
                f"DenoiserLoad.dtype={cfg.denoiser_load.dtype!r}: on CUDA the "
                "denoiser's kernels take bf16 weights only, so set "
                "DenoiserLoad.dtype='bfloat16' (a float32 engine on CUDA is "
                "ROADMAP item 4)")

        load = cfg.denoiser_load
        if load.file_url is not None and not (
                load.local_filename and os.path.exists(load.local_filename)):
            raise NotImplementedError(
                "downloading denoiser weights is not ported; fetch "
                f"{load.file_url} to DenoiserLoad.local_filename")
        denoiser = Denoiser.from_config(
            cfg.denoiser_cfg, dtype=dtype,
            **denoiser_kernel_flags(cfg, self.device))
        _load_or_init(denoiser, load.local_filename, seed)
        denoiser.to(self.device).eval()

        self.vae = VaeDecoder.from_config(cfg.vae_cfg)
        _load_or_init(self.vae, cfg.vae_cfg.weights_path, seed + 1,
                      keep=lambda k: k.startswith(("decoder.",
                                                   "post_quant_conv.")))
        self.vae.to(self.device, resolve_dtype(cfg.vae_cfg.vae_dtype)).eval()

        self.clip_model = ClipTextModel.from_config(
            cfg.clip_cfg, dtype=resolve_dtype(cfg.clip_cfg.clip_dtype))
        text_keys = set(self.clip_model.state_dict())
        _load_or_init(self.clip_model, cfg.clip_cfg.weights_path, seed + 2,
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
