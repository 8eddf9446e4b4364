"""Parameter trees of the JAX package -> `state_dict`s of the port.

Plain numpy: each function takes the JAX package's nested parameter
dict (its leaves already numpy arrays, e.g.
`jax.tree.map(np.asarray, params)`) and returns a flat
`{name: np.ndarray}` dict in the reference torch layout that the port's
modules load (`nn.Linear.weight` is (out, in), convolutions are OIHW).
Wrap the values with `torch.from_numpy` for `load_state_dict`.

The denoiser keys are the reference `Denoiser`'s, the VAE keys are
diffusers' `AutoencoderKL`'s, and the CLIP keys are openai CLIP's text side, so published checkpoints load
into the same modules.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

StateDict = Dict[str, np.ndarray]


def _f32(x) -> np.ndarray:
    return np.array(x, dtype=np.float32)  # a writable copy


def _linear(out: StateDict, name: str, leaf) -> None:
    out[f"{name}.weight"] = _f32(leaf["kernel"]).T.copy()
    if "bias" in leaf:
        out[f"{name}.bias"] = _f32(leaf["bias"])


def _norm(out: StateDict, name: str, leaf) -> None:
    out[f"{name}.weight"] = _f32(leaf["scale"])
    out[f"{name}.bias"] = _f32(leaf["bias"])


def _conv(out: StateDict, name: str, leaf) -> None:
    # flax HWIO -> torch OIHW
    out[f"{name}.weight"] = _f32(leaf["kernel"]).transpose(3, 2, 0, 1).copy()
    out[f"{name}.bias"] = _f32(leaf["bias"])


def sinusoidal_angular_speeds(embedding_dims: int) -> np.ndarray:
    """The reference's `SinusoidalEmbedding` buffer: 2*pi times
    log-spaced frequencies in [1, 1000], built in float64."""
    half = embedding_dims // 2
    freqs = np.exp(np.linspace(np.log(1.0), np.log(1000.0), half))
    return (2.0 * np.pi * freqs).astype(np.float32)


def denoiser_state_dict(params: Dict[str, Any], cfg) -> StateDict:
    """JAX `Denoiser` params -> reference `Denoiser` state_dict.

    cfg: a DenoiserConfig of either package (patch and channel sizes; a
    widened outpainting model's `input_channels`)."""
    p = cfg.patch_size
    c = cfg.n_channels
    in_ch = getattr(cfg, "input_channels", None) or c
    patch_dim = c * p * p
    sd: StateDict = {
        "fourier_feats.0.angular_speeds":
            sinusoidal_angular_speeds(cfg.noise_embed_dims),
        "denoiser_trans_block.precomputed_pos_enc":
            np.arange((cfg.image_size // p) ** 2, dtype=np.int64),
    }
    _linear(sd, "fourier_feats.1", params["fourier_dense1"])
    _linear(sd, "fourier_feats.3", params["fourier_dense2"])
    _linear(sd, "label_proj", params["label_proj"])
    _norm(sd, "norm", params["cond_norm"])

    tb = params["denoiser_trans_block"]
    pre = "denoiser_trans_block"
    sd[f"{pre}.patchify_and_embed.0.weight"] = (
        _f32(tb["patch_proj"]["kernel"]).T.reshape(patch_dim, in_ch, p, p).copy())
    sd[f"{pre}.patchify_and_embed.0.bias"] = _f32(tb["patch_proj"]["bias"])
    _norm(sd, f"{pre}.patchify_and_embed.2", tb["patch_norm1"])
    _linear(sd, f"{pre}.patchify_and_embed.3", tb["embed_proj"])
    _norm(sd, f"{pre}.patchify_and_embed.4", tb["patch_norm2"])
    sd[f"{pre}.pos_embed.weight"] = _f32(tb["pos_embed"])

    i = 0
    while f"decoder_block_{i}" in tb:
        base = f"{pre}.decoder_blocks.{i}"
        sd.update({f"{base}.{k}": v for k, v in
                   decoder_block_state_dict(tb[f"decoder_block_{i}"]).items()})
        i += 1

    _linear(sd, f"{pre}.out_proj.0", tb["out_proj"])
    return sd


def decoder_block_state_dict(blk: Dict[str, Any]) -> StateDict:
    """JAX `DecoderBlock` params -> the port's `DecoderBlock` state_dict, for
    each FFN: the sep-conv MLP (the reference layout), the plain MLP
    (`Dense_0`/`Dense_1` -> `mlp.mlp.0`/`mlp.mlp.2`) and the MoE
    (`router.kernel` (D, E) -> `mlp.router.weight` (E, D); `wi`, `bi`,
    `wo`, `bo` as they are, the layout `models.moe` defines)."""
    sd: StateDict = {}
    _linear(sd, "self_attention.qkv_linear", blk["self_attention"]["qkv_linear"])
    _linear(sd, "cross_attention.q_linear", blk["cross_attention"]["q_linear"])
    _linear(sd, "cross_attention.kv_linear", blk["cross_attention"]["kv_linear"])
    mlp = blk["mlp"]
    if "router" in mlp:  # MoEMLP: the expert stacks as they are
        sd["mlp.router.weight"] = _f32(mlp["router"]["kernel"]).T.copy()
        for n in ("wi", "bi", "wo", "bo"):
            sd[f"mlp.{n}"] = _f32(mlp[n])
    elif "Dense_0" in mlp:  # MLP: Linear, GELU, Linear
        _linear(sd, "mlp.mlp.0", mlp["Dense_0"])
        _linear(sd, "mlp.mlp.2", mlp["Dense_1"])
    else:
        # 1x1 convolutions (out, in, 1, 1) and the depthwise (hidden, 1, 3, 3)
        sd["mlp.mlp.0.weight"] = _f32(mlp["expand"]["kernel"]).T[:, :, None, None].copy()
        sd["mlp.mlp.0.bias"] = _f32(mlp["expand"]["bias"])
        sd["mlp.mlp.1.weight"] = _f32(mlp["depthwise_kernel"]).transpose(3, 2, 0, 1).copy()
        sd["mlp.mlp.1.bias"] = _f32(mlp["depthwise_bias"])
        sd["mlp.mlp.3.weight"] = _f32(mlp["contract"]["kernel"]).T[:, :, None, None].copy()
        sd["mlp.mlp.3.bias"] = _f32(mlp["contract"]["bias"])
    for n in ("norm1", "norm2", "norm3"):
        _norm(sd, n, blk[n])
    return sd


def _vae_resnet(sd: StateDict, name: str, leaf) -> None:
    _norm(sd, f"{name}.norm1", leaf["norm1"])
    _conv(sd, f"{name}.conv1", leaf["conv1"])
    _norm(sd, f"{name}.norm2", leaf["norm2"])
    _conv(sd, f"{name}.conv2", leaf["conv2"])
    if "conv_shortcut" in leaf:
        _conv(sd, f"{name}.conv_shortcut", leaf["conv_shortcut"])


def _vae_mid(sd: StateDict, name: str, mid) -> None:
    _vae_resnet(sd, f"{name}.resnets.0", mid["resnet_0"])
    _vae_resnet(sd, f"{name}.resnets.1", mid["resnet_1"])
    attn = mid["attn"]
    base = f"{name}.attentions.0"
    _norm(sd, f"{base}.group_norm", attn["group_norm"])
    for n in ("to_q", "to_k", "to_v"):
        _linear(sd, f"{base}.{n}", attn[n])
    _linear(sd, f"{base}.to_out.0", attn["to_out"])


def vae_decoder_state_dict(params: Dict[str, Any]) -> StateDict:
    """JAX `AutoencoderKL` params -> diffusers-layout state_dict of the
    decoder and `post_quant_conv` (what `VaeDecoder` loads)."""
    dec = params["decoder"]
    sd: StateDict = {}
    _conv(sd, "post_quant_conv", params["post_quant_conv"])
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    _vae_mid(sd, "decoder.mid_block", dec["mid_block"])
    i = 0
    while f"up_{i}_resnet_0" in dec:
        j = 0
        while f"up_{i}_resnet_{j}" in dec:
            _vae_resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}",
                        dec[f"up_{i}_resnet_{j}"])
            j += 1
        if f"up_{i}_upsample" in dec:
            _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                  dec[f"up_{i}_upsample"]["conv"])
        i += 1
    _norm(sd, "decoder.conv_norm_out", dec["conv_norm_out"])
    _conv(sd, "decoder.conv_out", dec["conv_out"])
    return sd


def vae_encoder_state_dict(params: Dict[str, Any]) -> StateDict:
    """JAX `AutoencoderKL` params -> diffusers-layout state_dict of the
    encoder and `quant_conv`: the inverse of the JAX package's
    `convert_torch_vae_state_dict` (models/torch_compat.py) on these
    keys."""
    enc = params["encoder"]
    sd: StateDict = {}
    _conv(sd, "quant_conv", params["quant_conv"])
    _conv(sd, "encoder.conv_in", enc["conv_in"])
    i = 0
    while f"down_{i}_resnet_0" in enc:
        j = 0
        while f"down_{i}_resnet_{j}" in enc:
            _vae_resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}",
                        enc[f"down_{i}_resnet_{j}"])
            j += 1
        if f"down_{i}_downsample" in enc:
            _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                  enc[f"down_{i}_downsample"]["conv"])
        i += 1
    _vae_mid(sd, "encoder.mid_block", enc["mid_block"])
    _norm(sd, "encoder.conv_norm_out", enc["conv_norm_out"])
    _conv(sd, "encoder.conv_out", enc["conv_out"])
    return sd


def vae_state_dict(params: Dict[str, Any]) -> StateDict:
    """JAX `AutoencoderKL` params -> the whole autoencoder's diffusers-layout
    state_dict (what `AutoencoderKL` loads)."""
    return {**vae_decoder_state_dict(params), **vae_encoder_state_dict(params)}


def clip_text_state_dict(params: Dict[str, Any]) -> StateDict:
    """JAX `ClipTextModel` params -> openai CLIP text-side state_dict."""
    sd: StateDict = {
        "token_embedding.weight": _f32(params["token_embedding"]["embedding"]),
        "positional_embedding": _f32(params["positional_embedding"]),
        "text_projection": _f32(params["text_projection"]),
    }
    _norm(sd, "ln_final", params["ln_final"])
    i = 0
    while f"resblock_{i}" in params:
        blk = params[f"resblock_{i}"]
        base = f"transformer.resblocks.{i}"
        _norm(sd, f"{base}.ln_1", blk["ln_1"])
        sd[f"{base}.attn.in_proj_weight"] = (
            _f32(blk["attn_in_proj"]["kernel"]).T.copy())
        sd[f"{base}.attn.in_proj_bias"] = _f32(blk["attn_in_proj"]["bias"])
        _linear(sd, f"{base}.attn.out_proj", blk["attn_out_proj"])
        _norm(sd, f"{base}.ln_2", blk["ln_2"])
        _linear(sd, f"{base}.mlp.c_fc", blk["mlp_c_fc"])
        _linear(sd, f"{base}.mlp.c_proj", blk["mlp_c_proj"])
        i += 1
    return sd


def hf_clip_state_dict(sd):
    """HF transformers CLIPModel / CLIPTextModel keys (`text_model.*`, e.g.
    openai/clip-vit-large-patch14) -> openai CLIP's text-side layout, which
    `ClipTextModel` loads: the separate q/k/v projections fused into
    `attn.in_proj_*` (q, k, v stacked on the output axis), and the (proj,
    width) `text_projection.weight` transposed to openai's (width, proj)
    matrix; vision keys are dropped. The rename of the JAX package's
    `convert_hf_clip_state_dict` (models/torch_compat.py), onto torch's
    layout. Values are torch tensors."""
    import torch

    pre = "text_model."
    out = {
        "token_embedding.weight": sd[pre + "embeddings.token_embedding.weight"],
        "positional_embedding": sd[pre + "embeddings.position_embedding.weight"],
        "ln_final.weight": sd[pre + "final_layer_norm.weight"],
        "ln_final.bias": sd[pre + "final_layer_norm.bias"],
        "text_projection": sd["text_projection.weight"].T,
    }
    i = 0
    while f"{pre}encoder.layers.{i}.layer_norm1.weight" in sd:
        src, dst = f"{pre}encoder.layers.{i}", f"transformer.resblocks.{i}"
        for part in ("weight", "bias"):
            out[f"{dst}.attn.in_proj_{part}"] = torch.cat(
                [sd[f"{src}.self_attn.{n}_proj.{part}"] for n in "qkv"])
        for a, b in (("attn.out_proj", "self_attn.out_proj"), ("ln_1", "layer_norm1"),
                     ("ln_2", "layer_norm2"), ("mlp.c_fc", "mlp.fc1"),
                     ("mlp.c_proj", "mlp.fc2")):
            out[f"{dst}.{a}.weight"] = sd[f"{src}.{b}.weight"]
            out[f"{dst}.{a}.bias"] = sd[f"{src}.{b}.bias"]
        i += 1
    return out

