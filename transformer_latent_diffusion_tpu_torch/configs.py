"""Configuration dataclasses of the PyTorch port.

Same dataclass names, field names and defaults as the JAX package's
`configs.py`, so one `config_to_json` file configures either package.
Dtypes stay strings in the configs (they round-trip through JSON);
`resolve_dtype` maps them to torch dtypes. Fields whose feature the port
does not run yet keep their defaults; `check_train_config` raises
NotImplementedError, naming the ROADMAP item, for any other value.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Optional, Tuple, Union

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
class DataDownloadConfig:
    """Where and how latents were made (the data-preparation step is not
    ported yet; the dataclass keeps `ModelConfig`'s JSON whole)."""

    data_link: str
    caption_col: str = "caption"
    url_col: str = "url"
    latent_save_path: str = "latents_folder"
    raw_imgs_save_path: str = "raw_imgs_folder"
    use_drive: bool = False
    initial_csv_path: str = "imgs.csv"
    number_sample_per_shard: int = 10000
    image_size: int = 256
    batch_size: int = 64
    download_data: bool = True
    first_n_rows: int = 1000000
    use_wandb: bool = False
    process_index: int = 0
    process_count: int = 1


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
    # the FFN: "sep_conv" (LocalViT), "mlp" (Linear/GELU/Linear) or "moe"
    # (Switch top-1 mixture of experts; models.blocks.MLP_CLASSES)
    mlp_class: str = "sep_conv"
    n_experts: int = 8
    expert_capacity_factor: float = 1.25
    # width of the model's input latent; None = n_channels. The
    # outpainting model takes 2 * n_channels: the noisy latent, then the
    # masked context (models.denoiser.expand_input_channels)
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
    # the openai CLIP BPE vocab (bpe_simple_vocab_16e6.txt.gz); None or a
    # missing file = the HashTokenizer stand-in
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


@dataclass
class DataConfig:
    """Where the latent data is stored: (N, C, S, S) latents and (N, E)
    text embeddings as .npy, and the eval embeddings. `extra_*_paths`:
    further resolution buckets (multires training), paired by index."""

    latent_path: str
    text_emb_path: str
    val_path: str
    extra_latent_paths: Tuple[str, ...] = ()
    extra_text_emb_paths: Tuple[str, ...] = ()


@dataclass
class TrainConfig:
    """The JAX package's training knobs, same names and defaults.

    `compile` has no PyTorch meaning: the JAX package used it to donate
    the train state's buffers to its jitted step; the port runs eagerly
    and updates the state in place, so the field is read by nothing.
    `fused_layer_vjp` None = auto: the hand-written K2 kernels on CUDA,
    the plain autograd path on the CPU; False on CUDA raises, since the
    port has no switch off its kernels."""

    batch_size: int = 128
    lr: float = 3e-4
    n_epoch: int = 100
    alpha: float = 0.999
    from_scratch: bool = True
    beta_a: float = 1
    beta_b: float = 2.5
    save_and_eval_every_iters: int = 1000
    warmup_steps: int = 0
    lr_schedule: Optional[str] = None
    lr_decay_steps: int = 0
    lr_final_frac: float = 0.0
    grad_clip_norm: Optional[float] = None
    run_id: str = ""
    model_name: str = ""
    compile: bool = True
    save_model: bool = True
    use_wandb: bool = False
    val_holdout: int = 0
    loss_weighting: Optional[str] = None
    min_snr_gamma: float = 5.0
    log_grad_norm: bool = False
    offset_noise: float = 0.0
    schedule_shift: Optional[Union[float, str]] = None
    mesh_shape: Optional[Tuple[int, int]] = None
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    grad_accum_steps: int = 1
    checkpoint_dir: str = "checkpoints"
    seed: int = 0
    fused_mlp_vjp: Optional[bool] = None
    fused_attn_vjp: Optional[bool] = None
    fused_layer_vjp: Optional[bool] = None
    remat: Optional[bool] = None
    sequence_parallel: Optional[bool] = None
    pipeline_parallel: Optional[bool] = None
    pipeline_microbatches: Optional[int] = None
    fsdp: bool = False
    moe_aux_weight: float = 0.01
    outpaint: bool = False
    lora_rank: int = 0
    lora_alpha: Optional[float] = None
    lora_targets: Optional[Tuple[str, ...]] = None
    handle_signals: bool = True


@dataclass
class ModelConfig:
    """Main config for training: data, denoiser, training, eval towers."""

    data_config: DataConfig
    download_config: Optional[DataDownloadConfig] = None
    denoiser_config: DenoiserConfig = field(default_factory=DenoiserConfig)
    train_config: TrainConfig = field(default_factory=TrainConfig)
    vae_cfg: VaeConfig = field(default_factory=VaeConfig)
    clip_cfg: ClipConfig = field(default_factory=ClipConfig)


# (field, is the value unported?, ROADMAP item) of the training configs
_UNPORTED_TRAIN = (
    ("mesh_shape", lambda v: v is not None, "item 14 (parallelism)"),
    ("fsdp", bool, "item 14 (parallelism)"),
    ("pipeline_parallel", bool, "item 14 (parallelism)"),
    ("sequence_parallel", bool, "item 14 (parallelism)"),
    ("lora_rank", lambda v: v > 0, "item 11 (LoRA)"),
    ("use_wandb", bool, "item 12 (logging)"),
    ("param_dtype", lambda v: v != "float32", "item 7 (bf16 master weights)"),
)


def check_train_config(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a field whose feature the port does
    not run yet (set to anything but its default)."""
    tc = cfg.train_config
    for name, unported, item in _UNPORTED_TRAIN:
        value = getattr(tc, name)
        if unported(value):
            raise NotImplementedError(
                f"TrainConfig.{name}={value!r} is not ported yet (ROADMAP {item})")
    if cfg.denoiser_config.dropout:
        raise NotImplementedError("dropout > 0 is not ported yet (ROADMAP, "
                                  "what the training slice left out)")


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
