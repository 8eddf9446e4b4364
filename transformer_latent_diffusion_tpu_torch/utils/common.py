"""Shared utilities of the port: seeded random weights, parameter counts,
checkpoint files, image grids, PIL conversion and slerp."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def init_random_weights_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from a CPU `torch.Generator` seeded with
    `seed`, in the order of `named_parameters()`: biases zero, other 1-D
    parameters (norm scales) one, the rest normal with std
    1/sqrt(fan_in), fan_in being the elements per output row of the
    (out, ...) layout, or for the stacked experts of `models.moe.MoEMLP`
    (`wi` (E, D, H), `wo` (E, H, D), biases `bi`, `bo`) the middle axis.
    Random weights stand in where trained ones are not in the repository;
    buffers are left as they are."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("bias") or leaf in ("bi", "bo"):
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        else:
            fan_in = p.shape[1] if leaf in ("wi", "wo") else p[0].numel()
            std = 1.0 / math.sqrt(fan_in)
            p.copy_(torch.randn(p.shape, generator=gen) * std)
    return module


def count_parameters(module: nn.Module) -> int:
    """Number of parameter elements of a module (trainable or not)."""
    return sum(p.numel() for p in module.parameters())


# safetensors dtype names -> numpy dtypes (BF16 is read as int16 bits and
# viewed as torch.bfloat16: numpy has no bf16)
_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.int16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
WEIGHT_KINDS = ("denoiser", "vae", "clip")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file as a flat name -> CPU tensor dict, read with
    numpy (no safetensors package): an 8-byte little-endian header size, a
    JSON header of {name: {dtype, shape, data_offsets}} (offsets from the
    end of the header), then the raw little-endian buffer."""
    import json

    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        buf = f.read()
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        b, e = meta["data_offsets"]
        arr = np.frombuffer(buf[b:e], dtype=_SAFETENSORS_DTYPES[meta["dtype"]])
        t = torch.from_numpy(arr.reshape(meta["shape"]).copy())
        out[name] = t.view(torch.bfloat16) if meta["dtype"] == "BF16" else t
    return out


def _is_torchscript(path: str) -> bool:
    """Whether `path` is a TorchScript archive (openai's CLIP `.pt`
    files): a zip holding compiled code, which `torch.load` refuses."""
    import zipfile

    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("/constants.pkl") or "/code/" in n for n in z.namelist())


def _npz_state_dict(path: str, kind: str, cfg) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree saved as .npz (the JAX package's `save_npz` or
    `scripts/convert_towers.py`: leaves flattened with "/") as the port's
    state_dict of `kind`, through `convert`."""
    from transformer_latent_diffusion_tpu_torch import convert

    tree: Dict = {}
    with np.load(path) as data:
        for name in data.files:
            node = tree
            parts = name.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[name]
    if set(tree) == {"params"}:  # a flax variables dict
        tree = tree["params"]
    if kind == "denoiser":
        sd = convert.denoiser_state_dict(tree, cfg)
    elif kind == "vae":
        sd = convert.vae_state_dict(tree)
    else:
        sd = convert.clip_text_state_dict(tree)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def load_state_dict_file(path: str, kind: str = "denoiser",
                         cfg=None) -> Dict[str, torch.Tensor]:
    """The weights of a `kind` tower ("denoiser", "vae" or "clip") from
    any file format the JAX package loads, as a flat name -> tensor dict
    in the port's layout:

    - `.safetensors`, read with numpy (`read_safetensors`);
    - `.npz`, a JAX parameter tree (converted by `convert`; `cfg`, the
      DenoiserConfig, sizes a denoiser's patch layer);
    - a TorchScript archive (openai's CLIP `.pt`), through `torch.jit.load`;
    - any other torch checkpoint (.pth / .pt / .bin), `torch.load` with
      weights_only=True.

    An EMA checkpoint's `model_ema` entry (or, in a flat file, its
    `model_ema.` keys) is taken, the `_orig_mod.` prefix of torch.compile
    checkpoints is stripped, and HF transformers CLIP keys (`text_model.`)
    are renamed to openai's layout (`convert.hf_clip_state_dict`)."""
    if kind not in WEIGHT_KINDS:
        raise ValueError(f"kind is one of {WEIGHT_KINDS}, got {kind!r}")
    if path.endswith(".npz"):
        return _npz_state_dict(path, kind, cfg)
    if path.endswith(".safetensors"):
        sd = read_safetensors(path)
    elif _is_torchscript(path):
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model_ema" in sd:
        sd = sd["model_ema"]
    elif any(k.startswith("model_ema.") for k in sd):
        sd = {k[len("model_ema."):]: v for k, v in sd.items()
              if k.startswith("model_ema.")}
    sd = {(k[len("_orig_mod."):] if k.startswith("_orig_mod.") else k): v
          for k, v in sd.items()}
    if any(k.startswith("text_model.") for k in sd):
        from transformer_latent_diffusion_tpu_torch.convert import hf_clip_state_dict

        sd = hf_clip_state_dict(sd)
    return sd


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """Tile a batch (B, C, H, W) into one (C, H', W') grid
    (torchvision.utils.make_grid's layout)."""
    images = np.asarray(images)
    b, c, h, w = images.shape
    nrows = int(np.ceil(b / nrow))
    grid = np.full(
        (c, padding + nrows * (h + padding), padding + nrow * (w + padding)),
        pad_value, dtype=images.dtype)
    for idx in range(b):
        r, col = divmod(idx, nrow)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[:, y:y + h, x:x + w] = images[idx]
    return grid


def uint8_grid_to_pil(images_bhwc: np.ndarray, nrow: int = 8,
                      padding: int = 2):
    """Tile uint8 (B, H, W, 3) images into one PIL grid, pad value 0."""
    from PIL import Image

    images = np.asarray(images_bhwc)
    grid = make_grid(images.transpose(0, 3, 1, 2), nrow=nrow,
                     padding=padding, pad_value=0)
    if grid.shape[0] == 1:
        return Image.fromarray(grid[0], mode="L")
    return Image.fromarray(np.transpose(grid, (1, 2, 0)), mode="RGB")


def to_pil(img_chw: np.ndarray):
    """(C, H, W) float in [0, 1] -> PIL.Image (like ToPILImage)."""
    from PIL import Image

    arr = np.clip(np.asarray(img_chw), 0.0, 1.0)
    arr = (arr * 255.0 + 0.5).astype(np.uint8)
    if arr.shape[0] == 1:
        return Image.fromarray(arr[0], mode="L")
    return Image.fromarray(np.transpose(arr, (1, 2, 0)), mode="RGB")


def slerp(a: np.ndarray, b: np.ndarray, t) -> np.ndarray:
    """Spherical linear interpolation between two vectors (the JAX
    package's `utils.slerp`): `t` a scalar or 1-D array, the result
    (*t.shape, dim); along the great circle through a/|a| and b/|b| with
    the magnitudes interpolated linearly, so unit vectors stay unit
    (pooled CLIP embeddings live on a sphere); near-parallel inputs fall
    back to lerp. float32 numpy."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    t = np.asarray(t, dtype=np.float32)[..., None]
    na = float(np.linalg.norm(a))
    nb = float(np.linalg.norm(b))
    cos = float(np.clip(np.dot(a / na, b / nb), -1.0, 1.0))
    omega = float(np.arccos(cos))
    if omega < 1e-4:
        return (1.0 - t) * a + t * b
    so = np.sin(omega)
    unit = (np.sin((1.0 - t) * omega) * (a / na)
            + np.sin(t * omega) * (b / nb)) / so
    return ((1.0 - t) * na + t * nb) * unit
