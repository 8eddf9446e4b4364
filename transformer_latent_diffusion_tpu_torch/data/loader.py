"""Training batches from memory-mapped .npy latents and text embeddings.

The port's own copy of the JAX package's `data/loader.py::LatentBatcher`:
the same holdout, epoch order from the seed and static batch shapes, with
the gather in numpy (the JAX package's C++ gather, `data/native/`, is a
later item of the ROADMAP). uint8 latent stores are dequantized as there
(clip value 20).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def _gather(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Rows src[idx] as one contiguous float32 batch."""
    rows = src[idx]
    if src.dtype == np.uint8:
        return (rows.astype(np.float32) / 255.0 * 2.0 - 1.0) * 20.0
    return rows.astype(np.float32)


class LatentBatcher:
    """Shuffled, static-shape batches over memory-mapped .npy arrays.

    holdout: the LAST `holdout` examples never enter training batches;
    `holdout_batch()` hands them out for the validation loss. Each epoch
    is a permutation from a numpy generator seeded with `seed`; a last
    partial batch wraps around to the start of the permutation."""

    def __init__(self, latent_path: str, text_emb_path: str, batch_size: int,
                 seed: int = 0, holdout: int = 0):
        self.latents = np.load(latent_path, mmap_mode="r")
        self.text = np.load(text_emb_path, mmap_mode="r")
        if len(self.latents) != len(self.text):
            raise ValueError(f"{len(self.latents)} latents but "
                             f"{len(self.text)} text embeddings")
        self.n = len(self.latents)
        if not 0 <= holdout < self.n:
            raise ValueError(f"holdout={holdout} must be in [0, {self.n}) for "
                             f"a {self.n}-example dataset")
        self.holdout = holdout
        self.n -= holdout
        self.batch_size = min(batch_size, self.n)
        self.rng = np.random.default_rng(seed)

    def holdout_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """The held-out tail as one float32 (latents, text) batch."""
        if not self.holdout:
            raise ValueError("constructed with holdout=0")
        idx = np.arange(self.n, self.n + self.holdout)
        return _gather(self.latents, idx), _gather(self.text, idx)

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.n // self.batch_size)

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        perm = self.rng.permutation(self.n)
        bs = self.batch_size
        for it in range(self.steps_per_epoch):
            start = (it * bs) % self.n
            idx = perm[start:start + bs]
            if len(idx) < bs:  # wraparound keeps shapes static
                idx = np.concatenate([idx, perm[: bs - len(idx)]])
            yield _gather(self.latents, idx), _gather(self.text, idx)
