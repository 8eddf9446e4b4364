"""HTTP serving of image generation: the dependency-free WSGI app.

Counterpart of the WSGI frontend of the JAX package's `serve/app.py`:
`GET /` (welcome JSON), `GET /healthz` (device inventory snapshotted at
start, request counters) and `POST /generate-image/` with bearer-token
auth against the API_TOKEN environment variable, the request schema
{prompt, class_guidance=6, seed=11, num_imgs=1, img_size=32, n_iter=15,
...}, a JPEG response, 401 on a missing or wrong token, 422 on malformed
fields, and, as the JAX frontend, 500 with `{"detail": str(e)}` when the
body is not JSON, is a JSON value that is not an object (where the
prompt check does not already answer 422), or generation fails.

Text-to-image with the JAX service's solver fields: sampler ("ddim",
"dpm", "heun"), schedule, eta, cfg_rescale and cache_interval (block
caching), under its checks (eta and cfg_rescale in [0, 1], eta only with
sampler="ddim", heun without block caching), each a 422 that names the
field. Unlike the JAX service, eta and cfg_rescale are not snapped to
quarters: the sampler's captured graph holds only their branch, so any
value runs without a new capture. Editing with the JAX service's fields:
init_image (base64 PNG or JPEG: img2img, strength 0.5 by default), with
mask (inpainting, strength 1.0 by default), and interpolate_to and/or
seed_b (an interpolation strip of max(num_imgs, 2) frames); the solver
fields apply to text-to-image only, block caching on an init_image
request warns and samples exactly, and the JAX service's 422s for
combinations that do not compose. best_of answers 422 naming its ROADMAP
item.

Under load, as the JAX service: `microbatch` (or SERVE_MICROBATCH, a max
batch size) sends text-to-image and editing requests through the
micro-batcher (`serve/batcher.py`), which coalesces concurrent requests
into one sampler call; a request that would overflow its bounded queue is
answered 503 with a Retry-After header; /healthz reports the queue
(`queue_imgs`, `queue_limit`) and "warming" while the startup warm-up
(`warmup` or SERVE_WARMUP) runs. The FastAPI frontend waits (ROADMAP item
10): `fastapi` is not a dependency of the port.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Optional

from transformer_latent_diffusion_tpu_torch.configs import LTDConfig
from transformer_latent_diffusion_tpu_torch.serve.errors import QueueFull

# "read the SERVE_* environment variable, else the class default"
_ENV_DEFAULT = object()


def default_config() -> LTDConfig:
    """What the service runs when given no config: `LTDConfig()`, as the
    JAX service (its float32 denoiser runs the kernels' float32 bodies on
    CUDA; `LTDConfig(denoiser_load=DenoiserLoad(dtype="bfloat16"))` serves
    the bf16 ones)."""
    return LTDConfig()


class GenerationService:
    """The model behind the frontend.

    cfg: the LTDConfig to build (None: `default_config()`). num_imgs is
    snapped up to a bucket (the padded images are generated
    and dropped) and n_iter up to a bucket (the largest bucket caps the
    step count), so that only a few batch shapes and step counts ever
    run. `num_imgs_buckets` / `n_iter_buckets` (else SERVE_NUM_IMGS_BUCKETS
    / SERVE_N_ITER_BUCKETS; "" or "0" disables) set the buckets.

    The JAX service's load settings: `microbatch` (else SERVE_MICROBATCH),
    the micro-batcher's max batch (None or 0: no batcher): text-to-image
    requests without block caching and editing requests of at most that
    many images ride it, interpolation strips and larger requests take the
    solo path; `max_wait_ms` (else SERVE_MICROBATCH_WAIT_MS, 25) its wait
    for a batch to fill; `max_queue_imgs` its queue bound (else
    SERVE_MICROBATCH_MAX_QUEUE, 8 x microbatch); `request_timeout_s` (else
    SERVE_TIMEOUT_S, 900) how long a request waits for the batcher;
    `warmup` (else SERVE_WARMUP) runs the default request once in a
    background thread at startup, /healthz saying "warming" meanwhile."""

    DEFAULT_NUM_IMGS_BUCKETS = (1, 2, 4, 8, 16, 32)
    DEFAULT_N_ITER_BUCKETS = (4, 8, 15, 25, 50)

    @staticmethod
    def _env_buckets(env: str, default):
        raw = os.getenv(env)
        if raw is None:
            return default
        raw = raw.strip()
        if not raw or raw == "0":
            return None
        return tuple(sorted(int(x) for x in raw.split(",")))

    @staticmethod
    def _snap_up(value: int, buckets) -> int:
        """Smallest bucket >= value, else the largest bucket."""
        for b in buckets:
            if b >= value:
                return b
        return buckets[-1]

    def __init__(self, cfg: Optional[LTDConfig] = None, device=None,
                 transformer=None, microbatch: Optional[int] = None,
                 max_wait_ms=_ENV_DEFAULT,
                 request_timeout_s: Optional[float] = None,
                 num_imgs_buckets=_ENV_DEFAULT, n_iter_buckets=_ENV_DEFAULT,
                 warmup=_ENV_DEFAULT, max_queue_imgs: Optional[int] = None):
        if transformer is None:
            if device is None:
                raise ValueError("GenerationService needs a device "
                                 "(or a built transformer)")
            from transformer_latent_diffusion_tpu_torch.sampling.pipeline import (
                DiffusionTransformer,
            )

            transformer = DiffusionTransformer(cfg or default_config(),
                                               device=device)
        self.transformer = transformer
        if num_imgs_buckets is _ENV_DEFAULT:
            num_imgs_buckets = self._env_buckets("SERVE_NUM_IMGS_BUCKETS",
                                                 self.DEFAULT_NUM_IMGS_BUCKETS)
        if n_iter_buckets is _ENV_DEFAULT:
            n_iter_buckets = self._env_buckets("SERVE_N_ITER_BUCKETS",
                                               self.DEFAULT_N_ITER_BUCKETS)
        self.num_imgs_buckets = (tuple(sorted(num_imgs_buckets))
                                 if num_imgs_buckets else None)
        self.n_iter_buckets = (tuple(sorted(n_iter_buckets))
                               if n_iter_buckets else None)
        if microbatch is None and os.getenv("SERVE_MICROBATCH"):
            microbatch = int(os.environ["SERVE_MICROBATCH"])
        if max_wait_ms is _ENV_DEFAULT:
            max_wait_ms = float(os.getenv("SERVE_MICROBATCH_WAIT_MS", "25"))
        if request_timeout_s is None:
            request_timeout_s = float(os.getenv("SERVE_TIMEOUT_S", "900"))
        self.request_timeout_s = request_timeout_s
        self.batcher = None
        if microbatch:
            from transformer_latent_diffusion_tpu_torch.serve.batcher import (
                MicroBatcher,
            )

            self.batcher = MicroBatcher(transformer, max_batch=microbatch,
                                        max_wait_ms=max_wait_ms,
                                        max_queue_imgs=max_queue_imgs)
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "images": 0, "errors": 0,
                       "generate_seconds": 0.0}
        # snapshot the device inventory now; health() never queries it live
        dev = transformer.device
        if dev.type == "cuda":
            import torch

            self._device_info = {
                "backend": "cuda",
                "n_devices": torch.cuda.device_count(),
                "device_kind": torch.cuda.get_device_name(dev),
            }
        else:
            self._device_info = {"backend": dev.type, "n_devices": 1,
                                 "device_kind": dev.type}
        self._warmup_thread = None
        if warmup is _ENV_DEFAULT:
            warmup = os.getenv("SERVE_WARMUP", "") not in ("", "0")
        if warmup:
            def _warm():
                try:  # not generate_jpeg: the warm-up is not a request
                    self._generate_jpeg("warmup", num_imgs=1)
                except Exception as e:  # the server stays up
                    print(f"serve warmup failed: {type(e).__name__}: {e}",
                          flush=True)

            self._warmup_thread = threading.Thread(
                target=_warm, name="serve-warmup", daemon=True)
            self._warmup_thread.start()

    def effective_n_iter(self, n_iter) -> Optional[int]:
        """The step count a request actually runs after bucketing."""
        if isinstance(n_iter, bool) or not isinstance(n_iter, int):
            return None
        if self.n_iter_buckets:
            return self._snap_up(n_iter, self.n_iter_buckets)
        return n_iter

    def health(self) -> dict:
        """The /healthz payload: "warming" while the startup warm-up runs,
        the batcher's queue, the device inventory snapshotted at start and
        the request counters."""
        warming = (self._warmup_thread is not None
                   and self._warmup_thread.is_alive())
        info = {"status": "warming" if warming else "ok",
                "microbatch": self.batcher is not None}
        if self.batcher is not None:
            info["queue_imgs"] = self.batcher.queue_depth()
            info["queue_limit"] = self.batcher.max_queue_imgs
        info.update(self._device_info)
        with self._stats_lock:
            info.update(self._stats)
        return info

    def retry_after_hint(self) -> int:
        """Seconds a client answered 503 should wait: the mean time of the
        requests served so far, at least 1 (2 before any was served)."""
        with self._stats_lock:
            n = self._stats["requests"] - self._stats["errors"]
            if n > 0:
                return max(1, math.ceil(self._stats["generate_seconds"] / n))
        return 2

    def generate_jpeg(self, prompt: str, num_imgs: int = 1, **kwargs) -> bytes:
        """Counted and timed wrapper of `_generate_jpeg` (feeds /healthz)."""
        t0 = time.perf_counter()
        try:
            jpeg = self._generate_jpeg(prompt, num_imgs=num_imgs, **kwargs)
        except Exception:
            with self._stats_lock:
                self._stats["requests"] += 1
                self._stats["errors"] += 1
            raise
        with self._stats_lock:
            self._stats["requests"] += 1
            self._stats["images"] += num_imgs
            self._stats["generate_seconds"] += time.perf_counter() - t0
        return jpeg

    def _generate_jpeg(self, prompt: str, class_guidance: float = 6,
                       seed: int = 11, num_imgs: int = 1, img_size: int = 32,
                       n_iter: int = 15, cache_interval: int = 1,
                       negative_prompt: Optional[str] = None,
                       init_image: Optional[str] = None,
                       mask: Optional[str] = None,
                       strength: Optional[float] = None,
                       interpolate_to: Optional[str] = None,
                       seed_b: Optional[int] = None,
                       sampler: Optional[str] = None,
                       schedule: str = "poly", cfg_rescale: float = 0.0,
                       eta: float = 0.0) -> bytes:
        import io

        if self.n_iter_buckets:
            n_iter = self._snap_up(n_iter, self.n_iter_buckets)
        pad_to = None
        if self.num_imgs_buckets and num_imgs <= self.num_imgs_buckets[-1]:
            pad_to = self._snap_up(num_imgs, self.num_imgs_buckets)
            if pad_to == num_imgs:
                pad_to = None
        edit_kw = dict(class_guidance=class_guidance, seed=seed,
                       num_imgs=num_imgs, n_iter=n_iter,
                       negative_prompt=negative_prompt, pad_to=pad_to)
        if init_image is not None:
            # img2img / inpainting of a base64 PNG or JPEG
            if cache_interval > 1:
                import warnings

                warnings.warn("cache_interval is not supported on the "
                              "img2img/inpaint path; sampling exactly")
            if strength is None:  # inpainting regenerates fully by default
                strength = 1.0 if mask is not None else 0.5
            src = _open_image(init_image).convert("RGB")
            if self.batcher is not None and num_imgs <= self.batcher.max_batch:
                img = self.batcher.generate(
                    prompt=prompt, class_guidance=class_guidance, seed=seed,
                    num_imgs=num_imgs, n_iter=n_iter,
                    negative_prompt=negative_prompt, init_image=src,
                    mask=None if mask is None else _open_image(mask).convert("L"),
                    strength=strength, timeout=self.request_timeout_s)
            elif mask is not None:
                img = self.transformer.inpaint(
                    src, _open_image(mask).convert("L"), prompt,
                    strength=strength, **edit_kw)
            else:
                img = self.transformer.image_to_image(
                    src, prompt, strength=strength, **edit_kw)
        elif interpolate_to is not None or seed_b is not None:
            # an interpolation strip: num_imgs is the frame count
            img = self.transformer.interpolate(
                prompt, interpolate_to, n_frames=max(num_imgs, 2),
                class_guidance=class_guidance, seed=seed, seed_b=seed_b,
                n_iter=n_iter, negative_prompt=negative_prompt)
        elif (self.batcher is not None and cache_interval == 1
                and num_imgs <= self.batcher.max_batch):
            img = self.batcher.generate(
                prompt=prompt, class_guidance=class_guidance, seed=seed,
                num_imgs=num_imgs, img_size=img_size, n_iter=n_iter,
                negative_prompt=negative_prompt, sampler=sampler,
                schedule=schedule, cfg_rescale=cfg_rescale, eta=eta,
                timeout=self.request_timeout_s)
        else:
            solver_kw = {}
            if sampler is not None:
                solver_kw["sampler"] = sampler
            if schedule != "poly":
                solver_kw["schedule"] = schedule
            img = self.transformer.generate_image_from_text(
                prompt=prompt, class_guidance=class_guidance, seed=seed,
                num_imgs=num_imgs, img_size=img_size, n_iter=n_iter,
                cache_interval=cache_interval,
                negative_prompt=negative_prompt, pad_to=pad_to,
                cfg_rescale=cfg_rescale, eta=eta, **solver_kw)
        buf = io.BytesIO()
        img.save(buf, format="JPEG")
        return buf.getvalue()


def _open_image(b64: str):
    """A base64 PNG or JPEG payload as a PIL image."""
    import base64
    import io

    import PIL.Image

    return PIL.Image.open(io.BytesIO(base64.b64decode(b64)))


WELCOME = {"message": "Welcome to Image Generator"}
# the request fields and their defaults
REQUEST_DEFAULTS = {"class_guidance": 6, "seed": 11, "num_imgs": 1,
                    "img_size": 32, "n_iter": 15, "cache_interval": 1,
                    "negative_prompt": None, "init_image": None,
                    "mask": None, "strength": None, "interpolate_to": None,
                    "seed_b": None, "sampler": None, "schedule": "poly",
                    "cfg_rescale": 0.0, "eta": 0.0}
NON_NULLABLE_FIELDS = ("prompt", "class_guidance", "seed", "num_imgs",
                       "img_size", "n_iter", "cache_interval", "schedule",
                       "cfg_rescale", "eta")
INT_FIELDS = ("class_guidance", "seed", "num_imgs", "img_size", "n_iter",
              "cache_interval", "seed_b", "best_of")
# fields of the JAX service that the port does not serve yet -> ROADMAP item
NOT_PORTED_FIELDS = {"best_of": "item 12 (eval towers)"}
EDITING_FIELDS = ("init_image", "interpolate_to", "seed_b")


def _validate_int_fields(payload: dict) -> Optional[str]:
    """pydantic-v2-style lax int coercion: ints pass, bools and integral
    floats or numeric strings coerce (written back), the rest is a 422."""
    for k in INT_FIELDS:
        v = payload.get(k)
        if v is None:
            continue
        if isinstance(v, bool):
            payload[k] = int(v)
            continue
        if isinstance(v, int):
            continue
        if isinstance(v, str):
            try:
                v = float(v)
            except ValueError:
                return f"{k} must be an integer"
        if isinstance(v, float) and v.is_integer():
            payload[k] = int(v)
        else:
            return f"{k} must be an integer"
    return None


def _validate_fields(payload: dict) -> Optional[str]:
    """422-level checks of a request, in the JAX WSGI app's order; an error
    text or None."""
    if payload.get("init_image") is None and (
            payload.get("mask") is not None
            or payload.get("strength") is not None):
        return "mask/strength require init_image"
    if payload.get("init_image") is not None and (
            payload.get("interpolate_to") is not None
            or payload.get("seed_b") is not None):
        return "interpolate_to/seed_b do not compose with init_image"
    for k in NON_NULLABLE_FIELDS:
        if k in payload and payload[k] is None:
            return f"{k} must not be null"
    for k, item in NOT_PORTED_FIELDS.items():
        if payload.get(k) is not None:
            return f"{k} is not served by this port yet (ROADMAP {item})"
    sampler = payload.get("sampler")
    schedule = payload.get("schedule", "poly")
    if sampler is not None and not isinstance(sampler, str):
        return "sampler must be a string"
    if not isinstance(schedule, str):
        return "schedule must be a string"
    for k in ("cfg_rescale", "eta"):  # pydantic v2 lax floats, written back
        try:
            payload[k] = float(payload.get(k, 0.0))
        except (TypeError, ValueError):
            return f"{k} must be a number"
    if sampler is not None and sampler not in ("ddim", "dpm", "heun"):
        return "sampler must be one of 'ddim', 'dpm', 'heun'"
    if schedule not in ("poly", "cosine", "karras"):
        return "schedule must be one of 'poly', 'cosine', 'karras'"
    if not 0.0 <= payload["cfg_rescale"] <= 1.0:
        return "cfg_rescale must be in [0, 1]"
    if not 0.0 <= payload["eta"] <= 1.0:
        return "eta must be in [0, 1]"
    if payload["eta"] and sampler != "ddim":
        return "eta > 0 (stochastic DDIM) requires sampler='ddim'"
    non_default = (sampler is not None or schedule != "poly"
                   or bool(payload["cfg_rescale"]) or bool(payload["eta"]))
    if non_default and any(payload.get(k) is not None for k in EDITING_FIELDS):
        return ("sampler/schedule/cfg_rescale/eta apply to plain "
                "text-to-image requests only")
    if sampler == "heun" and payload.get("cache_interval", 1) > 1:
        return "cache_interval > 1 excludes sampler='heun'"
    if not isinstance(payload["prompt"], str):
        return "prompt must be a string"
    if not isinstance(payload.get("negative_prompt") or "", str):
        return "negative_prompt must be a string"
    if payload.get("num_imgs", 1) < 1 or payload.get("n_iter", 15) < 1:
        return "num_imgs and n_iter must be >= 1"
    return None


def _check_token(auth_header: Optional[str]):
    """(status, detail): 401 on a missing or wrong bearer token."""
    if not auth_header or not auth_header.lower().startswith("bearer "):
        return 401, "Not authenticated"
    if auth_header[7:] != os.getenv("API_TOKEN"):
        return 401, "Invalid authentication credentials"
    return 200, None


_REASONS = {200: "OK", 401: "Unauthorized", 404: "Not Found",
            422: "Unprocessable Entity", 500: "Internal Server Error",
            503: "Service Unavailable"}


def create_wsgi_app(cfg: Optional[LTDConfig] = None, service=None,
                    device=None):
    """The WSGI app over `service`, or over a new GenerationService built
    from `cfg` on `device`."""
    svc = service or GenerationService(cfg, device=device)

    def app(environ, start_response):
        method = environ["REQUEST_METHOD"]
        path = environ.get("PATH_INFO", "/")

        def respond(status_code, body, content_type="application/json",
                    extra_headers=()):
            headers = [("Content-Type", content_type),
                       ("Content-Length", str(len(body)))]
            headers.extend(extra_headers)
            if status_code == 401:
                headers.append(("WWW-Authenticate", "Bearer"))
            start_response(f"{status_code} {_REASONS[status_code]}", headers)
            return [body]

        def detail(status_code, text):
            return respond(status_code, json.dumps({"detail": text}).encode())

        if path == "/" and method == "GET":
            return respond(200, json.dumps(WELCOME).encode())
        if path == "/healthz" and method == "GET":
            return respond(200, json.dumps(svc.health()).encode())
        if path == "/generate-image/" and method == "POST":
            status, text = _check_token(environ.get("HTTP_AUTHORIZATION"))
            if status != 200:
                return detail(status, text)
            # as the JAX frontend: any exception from the body's parsing on
            # (a body that is not JSON, or a JSON value without .get) is a
            # 500 with str(e) as its detail (the reference's 500 semantics)
            try:
                length = int(environ.get("CONTENT_LENGTH") or 0)
                payload = json.loads(environ["wsgi.input"].read(length) or b"{}")
                if "prompt" not in payload:
                    return detail(422, "prompt is required")
                err = _validate_int_fields(payload) or _validate_fields(payload)
                if err:
                    return detail(422, err)
                kwargs = {k: payload.get(k, v) for k, v in REQUEST_DEFAULTS.items()}
                jpeg = svc.generate_jpeg(prompt=payload["prompt"], **kwargs)
                eff = svc.effective_n_iter(kwargs["n_iter"])
                extra = ([("X-Effective-N-Iter", str(eff))]
                         if eff is not None and eff != kwargs["n_iter"] else [])
                return respond(200, jpeg, content_type="image/jpeg",
                               extra_headers=extra)
            except QueueFull as e:  # the batcher's queue is at its bound
                return respond(503, json.dumps({"detail": str(e)}).encode(),
                               extra_headers=[("Retry-After",
                                               str(svc.retry_after_hint()))])
            except Exception as e:
                return detail(500, str(e))
        return detail(404, "Not Found")

    app.service = svc
    return app


def serve(cfg: Optional[LTDConfig] = None, device="cuda",
          host: str = "0.0.0.0", port: int = 8000):
    """Serve with wsgiref, one thread per request."""
    from socketserver import ThreadingMixIn
    from wsgiref.simple_server import WSGIServer, make_server

    class _ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
        daemon_threads = True

    print(f"serving (wsgiref, threaded) on {host}:{port}")
    make_server(host, port, create_wsgi_app(cfg, device=device),
                server_class=_ThreadingWSGIServer).serve_forever()

