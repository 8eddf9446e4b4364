"""Inference configuration dataclasses of the PyTorch port.

Same dataclass names, field names and defaults as the JAX package's
`configs.py`, so one `config_to_json` file configures either package.
Dtypes stay strings in the configs (they round-trip through JSON);
`resolve_dtype` maps them to torch dtypes. `ModelConfig`, `TrainConfig`
and `DataConfig` belong to the training slice and are not here yet.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Optional, Tuple

import torch

_DTYPE_MAP = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


def resolve_dtype(dtype) -> torch.dtype:
    """Accept a dtype string or a torch dtype and return the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPE_MAP:
        raise ValueError(f"unknown dtype {dtype!r}; expected one of "
                         f"{sorted(_DTYPE_MAP)}")
    return _DTYPE_MAP[dtype]


@dataclass
class DenoiserConfig:
    """The denoiser's shape (defaults: the reference's tiny model)."""

    image_size: int = 16
    noise_embed_dims: int = 256
    patch_size: int = 2
    embed_dim: int = 128
    dropout: float = 0
    n_layers: int = 3
    text_emb_size: int = 768
    n_channels: int = 4
    mlp_multiplier: int = 4
    # "sep_conv" is the only FFN the port runs so far; "mlp" and "moe"
    # raise NotImplementedError at model construction
    mlp_class: str = "sep_conv"
    n_experts: int = 8
    expert_capacity_factor: float = 1.25
    # width of the model's input latent; None = n_channels (widened
    # outpainting inputs wait for the editing slice)
    input_channels: Optional[int] = None
    # what the network predicts: "x0", "eps" or "v"
    # (sampling.diffusion.prediction_to_x0)
    objective: str = "x0"


@dataclass
class DenoiserLoad:
    dtype: str = "float32"
    file_url: Optional[str] = None
    local_filename: Optional[str] = None


@dataclass
class VaeConfig:
    vae_scale_factor: float = 8
    vae_name: str = "madebyollin/sdxl-vae-fp16-fix"
    vae_dtype: str = "float32"
    # diffusers AutoencoderKL state_dict (.pth); None = random weights
    weights_path: Optional[str] = None
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4


@dataclass
class ClipConfig:
    clip_model_name: str = "ViT-L/14"
    clip_dtype: str = "float16"
    # openai CLIP state_dict (.pth); None = random weights
    weights_path: Optional[str] = None
    # the CLIP BPE vocab; the BPE tokenizer is not ported yet, so a set
    # vocab_path raises NotImplementedError
    vocab_path: Optional[str] = None
    width: int = 768
    heads: int = 12
    layers: int = 12
    embed_dim: int = 768


@dataclass
class ClipVisionConfig:
    """The CLIP image tower's shape (a field of LTDConfig; the tower
    itself is not ported yet)."""

    weights_path: Optional[str] = None
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    heads: int = 16
    layers: int = 24
    embed_dim: int = 768
    dtype: str = "float32"


@dataclass
class LTDConfig:
    """Main inference config. Fields the port does not run yet keep
    their defaults; a non-default value raises NotImplementedError in
    `DiffusionTransformer`."""

    denoiser_cfg: DenoiserConfig = field(default_factory=DenoiserConfig)
    denoiser_load: DenoiserLoad = field(default_factory=DenoiserLoad)
    vae_cfg: VaeConfig = field(default_factory=VaeConfig)
    clip_cfg: ClipConfig = field(default_factory=ClipConfig)
    use_pallas: bool = True
    quantize: Optional[str] = None
    mesh_shape: Optional[Tuple[int, int]] = None
    sequence_parallel: Optional[bool] = None
    pipeline_parallel: bool = False
    pipeline_microbatches: Optional[int] = None
    lora_path: Optional[str] = None
    lora_scale: Optional[float] = None
    clip_vision_cfg: Optional[ClipVisionConfig] = None
    consistency: bool = False
    schedule_shift: Optional[float] = None


def config_to_json(cfg) -> str:
    return json.dumps(asdict(cfg))


def _detuple(value):
    # JSON has no tuples; every sequence field of the inference configs
    # wants one
    return tuple(value) if isinstance(value, list) else value


_LTD_NESTED = {
    "denoiser_cfg": DenoiserConfig,
    "denoiser_load": DenoiserLoad,
    "vae_cfg": VaeConfig,
    "clip_cfg": ClipConfig,
    "clip_vision_cfg": ClipVisionConfig,
}


def ltd_config_from_json(path_or_dict) -> LTDConfig:
    """Inverse of `config_to_json(LTDConfig(...))`: nested dataclasses are
    rebuilt and lists turned back into tuples. Unknown keys raise."""
    if isinstance(path_or_dict, (str, bytes)):
        with open(path_or_dict) as f:
            d = json.load(f)
    else:
        d = dict(path_or_dict)
    kw = {}
    for k, v in d.items():
        cls = _LTD_NESTED.get(k)
        if cls is not None and isinstance(v, dict):
            kw[k] = cls(**{nk: _detuple(nv) for nk, nv in v.items()})
        else:
            kw[k] = _detuple(v)
    return LTDConfig(**kw)
