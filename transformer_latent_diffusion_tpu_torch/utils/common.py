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


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint (.pth / .pt / .bin) as a flat name -> tensor dict.
    An EMA checkpoint's `model_ema` entry is taken, and the `_orig_mod.`
    prefix of torch.compile checkpoints is stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model_ema" in sd:
        sd = sd["model_ema"]
    return {(k[len("_orig_mod."):] if k.startswith("_orig_mod.") else k): v
            for k, v in sd.items()}


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
