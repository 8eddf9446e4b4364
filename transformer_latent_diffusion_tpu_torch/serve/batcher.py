"""Serving micro-batcher: concurrent generation requests coalesced into one
sampler call.

Counterpart of the JAX package's `serve/batcher.py` (`_Request`,
`MicroBatcher`). A batch of 16 images costs the card little more than a
batch of one (the step loop is a CUDA graph of ~60 kernel launches a step
whose time grows slowly with the batch), so concurrent HTTP requests are
better served by one loop than by one loop each.

- Requests enqueue and block on an event; one worker thread drains the
  queue, lingers `max_wait_ms` after a cycle's first request for others to
  join, and packs up to `max_batch` images. A request that does not fit
  is carried to the next cycle and served first.
- Each cycle groups its requests by the solver key (n_iter, sampler,
  schedule, cfg_rescale, eta) and the editing kind and strength (img2img,
  inpainting: a mask selects the masked loop, strength its length): only
  requests that run the same step loop share a call.
- A group's images are padded up to a bucket (`DEFAULT_BUCKETS`) with
  replicas of its first image, discarded after: a bucket is one batch
  shape, so each bucket's loop is one key of the sampler's CUDA graphs
  (`sampling/graph.py`), captured once and replayed for every later batch
  of that bucket, whatever its prompts, seeds and guidance.
- Each request keeps its own noise: its initial noise is drawn from a CPU
  `torch.Generator` seeded with its seed, as the solo path draws it
  (`DiffusionGenerator.initialize_image`), its eta noise from its own
  per-image seeds (`fresh_noise_image_seeds`), and the guidance and the
  CFG uncond embedding are per-image vectors. So a batched image is the
  solo image up to the float rounding of another batch size: within one
  uint8 step (tests/test_torch_port_batcher.py).
- The queue is bounded by images queued or in flight (`max_queue_imgs`,
  default SERVE_MICROBATCH_MAX_QUEUE or 8 x max_batch): a request that
  would pass the bound raises `QueueFull` at once, which the HTTP frontend
  answers with a 503 and a Retry-After header.
"""

from __future__ import annotations

import math
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from transformer_latent_diffusion_tpu_torch.serve.errors import QueueFull
from transformer_latent_diffusion_tpu_torch.utils.common import uint8_grid_to_pil

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


@dataclass
class _Request:
    prompt: str
    class_guidance: float
    seed: int
    num_imgs: int
    n_iter: int
    negative_prompt: Optional[str] = None
    # the solver key's other fields
    sampler: Optional[str] = None
    schedule: str = "poly"
    cfg_rescale: float = 0.0
    eta: float = 0.0
    # editing: (num_imgs, C, S, S) latents and (num_imgs, 1, S, S) mask on
    # the device; strength (its loop's length) is part of the group key
    init_latents: Optional[torch.Tensor] = None
    mask: Optional[np.ndarray] = None
    strength: Optional[float] = None
    done: threading.Event = field(default_factory=threading.Event)
    cancelled: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    # True once the request's images are back in the queue's budget
    released: bool = False


class MicroBatcher:
    """Coalesces `generate` calls into batched sampler calls.

    transformer: the `DiffusionTransformer` to serve. max_batch: the most
    images of one sampler call (also the largest bucket). max_wait_ms: how
    long the worker waits after a cycle's first request for others.
    buckets: the batch sizes a call is padded to. max_queue_imgs: images
    queued or in flight before `generate` raises `QueueFull` (None: the
    SERVE_MICROBATCH_MAX_QUEUE environment variable, else 8 x max_batch;
    0 or less: no bound)."""

    def __init__(self, transformer, max_batch: int = 32,
                 max_wait_ms: float = 25.0,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_queue_imgs: Optional[int] = None):
        self.transformer = transformer
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        if max_queue_imgs is None:
            max_queue_imgs = int(os.getenv("SERVE_MICROBATCH_MAX_QUEUE",
                                           str(8 * self.max_batch)))
        self.max_queue_imgs = (int(max_queue_imgs)
                               if max_queue_imgs and max_queue_imgs > 0 else None)
        self._queued_imgs = 0
        small = tuple(sorted(b for b in buckets if b < self.max_batch))
        self.buckets = small + (self.max_batch,)
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._closed = False
        # the closed check and the enqueue against close()'s drain
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="microbatcher")
        self._worker.start()

    # ------------------------------ API ------------------------------

    def generate(self, prompt: str, class_guidance: float = 6,
                 seed: int = 11, num_imgs: int = 1, img_size: int = 32,
                 n_iter: int = 15, timeout: Optional[float] = None,
                 negative_prompt: Optional[str] = None,
                 sampler: Optional[str] = None, schedule: str = "poly",
                 cfg_rescale: float = 0.0, eta: float = 0.0,
                 init_image=None, mask=None,
                 strength: Optional[float] = None):
        """Blocking generate: the PIL grid that
        `DiffusionTransformer.generate_image_from_text` gives (img_size is
        accepted and unused, as there), or with `init_image` (and `mask`,
        `strength`) the grid of `image_to_image` / `inpaint`. The init
        image is encoded and the mask pooled here, in the calling thread;
        strength defaults to 0.5 for img2img and 1.0 under a mask, as on
        the solo path."""
        num_imgs = int(num_imgs)
        if eta and sampler != "ddim":
            raise ValueError("eta > 0 (stochastic DDIM) requires sampler='ddim'")
        if eta and init_image is not None:
            raise ValueError("eta > 0 applies to plain text-to-image requests only")
        if mask is not None and init_image is None:
            raise ValueError("mask requires init_image (inpainting is masked img2img)")
        init_lat = pooled = None
        if init_image is not None:
            from transformer_latent_diffusion_tpu_torch.sampling.pipeline import (
                pool_mask_to_latent,
            )

            tr = self.transformer
            lat = tr._encode_init_image(init_image)
            if lat.shape[0] == 1:
                init_lat = lat.expand(num_imgs, -1, -1, -1)
            else:  # an input batch fixes num_imgs, as on the solo path
                num_imgs, init_lat = int(lat.shape[0]), lat
            if strength is None:
                strength = 1.0 if mask is not None else 0.5
            if mask is not None:
                pooled = np.repeat(pool_mask_to_latent(
                    mask, tr.diffuser.model.image_size), num_imgs, axis=0)
        elif strength is not None:
            raise ValueError("strength requires init_image")
        if not 1 <= num_imgs <= self.max_batch:
            raise ValueError(f"num_imgs={num_imgs} must be in [1, {self.max_batch}]")
        req = _Request(prompt=prompt, class_guidance=float(class_guidance),
                       seed=int(seed), num_imgs=num_imgs, n_iter=int(n_iter),
                       negative_prompt=negative_prompt, sampler=sampler,
                       schedule=str(schedule), cfg_rescale=float(cfg_rescale),
                       eta=float(eta), init_latents=init_lat, mask=pooled,
                       strength=None if strength is None else float(strength))
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if (self.max_queue_imgs is not None
                    and self._queued_imgs + num_imgs > self.max_queue_imgs):
                raise QueueFull(f"serving queue full ({self._queued_imgs} images "
                                f"queued, limit {self.max_queue_imgs}); retry later")
            self._queued_imgs += num_imgs
            self._queue.put(req)
        if not req.done.wait(timeout):
            # the worker skips it, and returns its images to the budget
            req.cancelled.set()
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def close(self):
        """Stop the worker; requests already queued are served first, later
        ones raise RuntimeError."""
        if self._closed:
            return
        with self._lock:
            self._closed = True
            self._queue.put(None)
        self._worker.join()
        while True:  # a request that raced past the closed check
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                r.error = RuntimeError("MicroBatcher is closed")
                r.done.set()
                self._release(r)

    def queue_depth(self) -> int:
        """Images queued or in flight."""
        with self._lock:
            return self._queued_imgs

    # ------------------------------ worker ------------------------------

    def _release(self, r: _Request):
        """Return a request's images to the budget, once per request."""
        with self._lock:
            if not r.released:
                r.released = True
                self._queued_imgs -= r.num_imgs

    def _run(self):
        carry: Optional[_Request] = None
        while True:
            if carry is not None:
                first, carry = carry, None
            else:
                first = self._queue.get()
                if first is None:
                    return
            if first.cancelled.is_set():
                self._release(first)
                continue
            batch, n_imgs = [first], first.num_imgs
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            while n_imgs < self.max_batch:
                try:
                    nxt = self._queue.get(timeout=max(deadline - time.monotonic(), 0.0))
                except queue.Empty:
                    break
                if nxt is None:  # serve this batch, then stop
                    self._queue.put(None)
                    break
                if nxt.cancelled.is_set():
                    self._release(nxt)
                    continue
                if n_imgs + nxt.num_imgs > self.max_batch:
                    carry = nxt
                    break
                batch.append(nxt)
                n_imgs += nxt.num_imgs
            groups = {}
            for r in batch:
                if r.cancelled.is_set():
                    self._release(r)
                    continue
                kind = ("inpaint" if r.mask is not None else
                        "img2img" if r.init_latents is not None else "t2i")
                key = (r.n_iter, r.sampler, r.schedule, r.cfg_rescale, r.eta,
                       kind, r.strength)
                groups.setdefault(key, []).append(r)
            for key, reqs in groups.items():
                try:
                    self._serve_group(reqs, *key)
                except Exception as e:  # the group's requests fail, the worker runs on
                    for r in reqs:
                        if not r.done.is_set():
                            r.error = e
                            r.done.set()
                finally:
                    for r in reqs:
                        self._release(r)

    def _bucket(self, n: int) -> int:
        return next((b for b in self.buckets if b >= n), self.buckets[-1])

    @torch.no_grad()
    def _serve_group(self, reqs: List[_Request], n_iter: int,
                     sampler: Optional[str], schedule: str, cfg_rescale: float,
                     eta: float, kind: str, strength: Optional[float]):
        from transformer_latent_diffusion_tpu_torch.sampling.diffusion import (
            fresh_noise_image_seeds,
        )

        tr = self.transformer
        gen = tr.diffuser
        size = gen.model.image_size
        prompts = [r.prompt for r in reqs for _ in range(r.num_imgs)]
        labels = tr.clip_model.encode_text(prompts, tr.tokenizer).float()
        negatives = None
        neg_prompts = sorted({r.negative_prompt for r in reqs
                              if r.negative_prompt is not None})
        if neg_prompts:  # zeros where a request has no negative prompt
            by_prompt = dict(zip(neg_prompts, tr.clip_model.encode_text(
                neg_prompts, tr.tokenizer).float()))
            negatives = torch.zeros_like(labels)
            off = 0
            for r in reqs:
                if r.negative_prompt is not None:
                    negatives[off:off + r.num_imgs] = by_prompt[r.negative_prompt]
                off += r.num_imgs
        # each request's initial noise from its own seed, as the solo path
        noises = [gen.initialize_image(None, r.num_imgs, size, r.seed) for r in reqs]
        guidance = [torch.full((r.num_imgs,), r.class_guidance) for r in reqs]
        image_seeds = [s for r in reqs for s in fresh_noise_image_seeds(r.seed, r.num_imgs)]
        inits = [r.init_latents for r in reqs] if kind != "t2i" else None
        masks = ([torch.from_numpy(np.asarray(r.mask, np.float32)) for r in reqs]
                 if kind == "inpaint" else None)

        n = labels.shape[0]
        b = self._bucket(n)
        pad = b - n
        if pad:  # replicas of the first image, discarded after
            labels = torch.cat([labels, labels[:1].expand(pad, -1)])
            noises.append(noises[0][:1].expand(pad, -1, -1, -1))
            guidance.append(torch.zeros(pad))
            image_seeds += image_seeds[:1] * pad
            if negatives is not None:
                negatives = torch.cat([negatives, negatives[:1].expand(pad, -1)])
            if inits is not None:
                inits.append(inits[0][:1].expand(pad, -1, -1, -1))
            if masks is not None:
                masks.append(masks[0][:1].expand(pad, -1, -1, -1))
        extra = {}
        if eta:  # sampler "ddim", checked at enqueue
            extra = dict(eta=eta, fresh_noise_keys=image_seeds)
        out, _ = gen.generate(
            labels=labels, seeds=torch.cat(noises), num_imgs=b, img_size=size,
            class_guidance=torch.cat(guidance), n_iter=n_iter, exponent=1,
            scale_factor=tr._scale_factor, sharp_f=0, bright_f=0, output="uint8",
            negative_labels=negatives, sampler=sampler, schedule=schedule,
            cfg_rescale=cfg_rescale,
            # the deployment's schedule shift applies to text-to-image only,
            # as on the solo path
            schedule_shift=tr.schedule_shift if kind == "t2i" else None,
            init_latents=None if inits is None else torch.cat(inits),
            strength=1.0 if strength is None else strength,
            mask=None if masks is None else torch.cat(masks), **extra)
        out = out.cpu().numpy()
        off = 0
        for r in reqs:
            imgs = out[off:off + r.num_imgs]
            off += r.num_imgs
            r.result = uint8_grid_to_pil(imgs, nrow=int(math.sqrt(r.num_imgs)), padding=4)
            self._release(r)  # the budget is back before the client wakes
            r.done.set()
