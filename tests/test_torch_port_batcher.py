"""The port's serving micro-batcher (`serve/batcher.py`) on the CPU, on a
tiny random model: the twelve cases of tests/test_batcher.py, then the
WSGI app's 503 and the service's SERVE_* settings and warm-up. Concurrent
requests coalesce into one sampler call per solver key and bucket, and
every batched image equals the solo `DiffusionTransformer` call's within
one uint8 step (the same float32 math at another batch size, summed in
other orders); the queue's bound sheds load with QueueFull and returns its
budget exactly once per request."""

import base64
import io
import threading
import time

import numpy as np
import PIL.Image
import pytest
import torch

from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch.sampling.pipeline import DiffusionTransformer
from transformer_latent_diffusion_tpu_torch.serve.app import GenerationService
from transformer_latent_diffusion_tpu_torch.serve.batcher import MicroBatcher
from transformer_latent_diffusion_tpu_torch.serve.errors import QueueFull

torch.set_num_threads(2)
PX = 16  # the tiny 2-block VAE: 8 x 8 latents, 16 px


def _tiny_transformer():
    return DiffusionTransformer(pc.LTDConfig(
        denoiser_cfg=pc.DenoiserConfig(image_size=8, embed_dim=64, n_layers=2,
                                       noise_embed_dims=64),
        vae_cfg=pc.VaeConfig(block_out_channels=(8, 16), layers_per_block=1),
        clip_cfg=pc.ClipConfig(width=64, heads=2, layers=2)), device="cpu")


def _within_one_step(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, f"{what}: max pixel diff {diff.max()}"


def _run_threads(jobs):
    """Run each job in its own thread; (results, errors)."""
    results, errors = [None] * len(jobs), []

    def run(i):
        try:
            results[i] = jobs[i]()
        except BaseException as e:  # surfaced in the main thread
            errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, errors


def _count_calls(tr, calls, what):
    orig = tr.diffuser.generate

    def counting(*a, **kw):
        calls.append(what(kw))
        return orig(*a, **kw)

    tr.diffuser.generate = counting
    return orig


REQS = [
    dict(prompt="a cute cat", class_guidance=6, seed=11, num_imgs=1, n_iter=4),
    dict(prompt="a red car", class_guidance=2.5, seed=3, num_imgs=1, n_iter=4),
    dict(prompt="a blue bird", class_guidance=6, seed=11, num_imgs=4, n_iter=4),
    # a negative prompt batches with the zero-uncond requests: the CFG
    # uncond half is a per-image embedding
    dict(prompt="a green tree", class_guidance=6, seed=7, num_imgs=1, n_iter=4,
         negative_prompt="blurry"),
]


def test_microbatcher_coalesces_and_matches_solo():
    tr = _tiny_transformer()
    solo = [np.asarray(tr.generate_image_from_text(**r)) for r in REQS]
    calls = []
    orig = _count_calls(tr, calls, lambda kw: kw.get("num_imgs"))
    mb = MicroBatcher(tr, max_batch=8, max_wait_ms=300.0)
    try:
        results, errors = _run_threads(
            [lambda r=r: mb.generate(**r, timeout=300) for r in REQS])
        assert not errors, errors
    finally:
        mb.close()
        tr.diffuser.generate = orig
    assert calls == [8], calls  # 1 + 1 + 4 + 1 images in the 8-bucket: one call
    for i, (img, ref) in enumerate(zip(results, solo)):
        assert isinstance(img, PIL.Image.Image)
        _within_one_step(img, ref, f"request {i}")


def test_microbatcher_eta_matches_solo():
    """eta-stochastic DDIM requests coalesce and keep their solo images:
    each image's step noise comes from its own request's per-image seeds."""
    tr = _tiny_transformer()
    reqs = [dict(prompt="a cute cat", class_guidance=6, seed=11, num_imgs=1,
                 n_iter=4, sampler="ddim", eta=0.5),
            dict(prompt="a red car", class_guidance=2.5, seed=3, num_imgs=2,
                 n_iter=4, sampler="ddim", eta=0.5)]
    solo = [np.asarray(tr.generate_image_from_text(**r)) for r in reqs]
    calls = []
    orig = _count_calls(tr, calls, lambda kw: (kw.get("num_imgs"), kw.get("eta"),
                                               kw.get("fresh_noise_keys") is not None))
    mb = MicroBatcher(tr, max_batch=8, max_wait_ms=300.0)
    try:
        results, errors = _run_threads(
            [lambda r=r: mb.generate(**r, timeout=300) for r in reqs])
        assert not errors, errors
    finally:
        mb.close()
        tr.diffuser.generate = orig
    assert calls == [(4, 0.5, True)], calls
    for i, (img, ref) in enumerate(zip(results, solo)):
        _within_one_step(img, ref, f"request {i}")
    mb2 = MicroBatcher(tr, max_batch=4, max_wait_ms=10.0)
    try:
        with pytest.raises(ValueError, match="stochastic DDIM"):
            mb2.generate(prompt="x", n_iter=4, eta=0.5, timeout=30)
    finally:
        mb2.close()


def test_microbatcher_groups_by_n_iter():
    tr = _tiny_transformer()
    calls = []
    orig = _count_calls(tr, calls, lambda kw: kw.get("n_iter"))
    mb = MicroBatcher(tr, max_batch=8, max_wait_ms=300.0)
    try:
        results, errors = _run_threads([
            lambda: mb.generate(prompt="x", n_iter=4, seed=1, timeout=300),
            lambda: mb.generate(prompt="y", n_iter=5, seed=2, timeout=300)])
        assert not errors, errors
        assert all(isinstance(r, PIL.Image.Image) for r in results)
    finally:
        mb.close()
        tr.diffuser.generate = orig
    assert sorted(calls) == [4, 5], calls


def test_service_microbatch_route():
    """GenerationService(microbatch=...) serves concurrent generate_jpeg
    calls through the batcher and returns JPEGs."""
    svc = GenerationService(transformer=_tiny_transformer(), microbatch=4,
                            max_wait_ms=200.0)
    try:
        assert svc.health()["microbatch"] and svc.health()["queue_imgs"] == 0
        out, errors = _run_threads([
            lambda s=s: svc.generate_jpeg(prompt="a cute cat", seed=s, n_iter=4)
            for s in (1, 2)])
        assert not errors, errors
        assert all(j[:3] == b"\xff\xd8\xff" for j in out)
        assert out[0] != out[1]  # other seeds, other images
    finally:
        svc.batcher.close()


def test_microbatcher_carry_and_close():
    """A request that does not fit a cycle is carried to the next one;
    close() serves what is queued and refuses later arrivals."""
    tr = _tiny_transformer()
    mb = MicroBatcher(tr, max_batch=2, max_wait_ms=150.0)
    try:
        results, errors = _run_threads([
            lambda: mb.generate(prompt="x", num_imgs=1, n_iter=4, seed=1, timeout=300),
            lambda: mb.generate(prompt="y", num_imgs=2, n_iter=4, seed=2, timeout=300),
            lambda: mb.generate(prompt="z", num_imgs=1, n_iter=4, seed=3, timeout=300)])
        assert not errors, errors
        assert all(isinstance(r, PIL.Image.Image) for r in results)
    finally:
        mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.generate("late", n_iter=4)


def test_service_oversize_falls_back_to_solo():
    """num_imgs above the batcher's max_batch takes the solo path."""
    svc = GenerationService(transformer=_tiny_transformer(), microbatch=2,
                            max_wait_ms=50.0)
    try:
        seen = []
        orig = svc.batcher.generate
        svc.batcher.generate = lambda *a, **kw: seen.append(kw) or orig(*a, **kw)
        jpeg = svc.generate_jpeg(prompt="a cute cat", num_imgs=4, n_iter=4)
        assert jpeg[:3] == b"\xff\xd8\xff" and seen == []
    finally:
        svc.batcher.close()


def test_microbatcher_rejects_bad_num_imgs():
    tr = _tiny_transformer()
    mb = MicroBatcher(tr, max_batch=4, max_wait_ms=10.0)
    try:
        for bad in (0, -1, 5):
            with pytest.raises(ValueError, match="num_imgs"):
                mb.generate("x", num_imgs=bad, n_iter=4, timeout=30)
        assert mb.queue_depth() == 0
    finally:
        mb.close()


def _images():
    rng = np.random.default_rng(5)
    img_a = PIL.Image.fromarray(rng.integers(0, 255, size=(PX, PX, 3), dtype=np.uint8))
    img_b = PIL.Image.fromarray(rng.integers(0, 255, size=(PX, PX, 3), dtype=np.uint8))
    mask = np.zeros((PX, PX), dtype=np.uint8)
    mask[: PX // 2] = 255
    return img_a, img_b, PIL.Image.fromarray(mask)


def test_microbatcher_batches_editing_and_matches_solo():
    """Concurrent img2img requests of one strength share a call, inpainting
    takes its own (the masked loop), text-to-image its own; each image is
    the solo call's within one uint8 step."""
    tr = _tiny_transformer()
    img_a, img_b, mask = _images()
    solo = [
        tr.image_to_image(img_a, "an oil painting", strength=0.5, seed=11,
                          num_imgs=1, n_iter=4),
        tr.image_to_image(img_b, "a watercolor", strength=0.5, class_guidance=2.5,
                          seed=3, num_imgs=2, n_iter=4),
        tr.inpaint(img_a, mask, "a castle", seed=7, num_imgs=1, n_iter=4),
        tr.generate_image_from_text("a cute cat", seed=11, num_imgs=1, n_iter=4),
    ]
    calls = []
    orig = _count_calls(tr, calls, lambda kw: (kw.get("num_imgs"), kw.get("mask") is not None,
                                               kw.get("init_latents") is not None))
    mb = MicroBatcher(tr, max_batch=8, max_wait_ms=400.0)
    try:
        results, errors = _run_threads([
            lambda: mb.generate("an oil painting", init_image=img_a, strength=0.5,
                                seed=11, num_imgs=1, n_iter=4, timeout=300),
            lambda: mb.generate("a watercolor", init_image=img_b, strength=0.5,
                                class_guidance=2.5, seed=3, num_imgs=2, n_iter=4,
                                timeout=300),
            lambda: mb.generate("a castle", init_image=img_a, mask=mask, seed=7,
                                num_imgs=1, n_iter=4, timeout=300),
            lambda: mb.generate("a cute cat", seed=11, num_imgs=1, n_iter=4,
                                timeout=300)])
        assert not errors, errors
    finally:
        mb.close()
        tr.diffuser.generate = orig
    assert sorted(calls) == [(1, False, False), (1, True, True), (4, False, True)], calls
    for i, (img, ref) in enumerate(zip(results, solo)):
        _within_one_step(img, ref, f"request {i}")


def test_microbatcher_editing_validation():
    """mask or strength without init_image is refused before it enqueues."""
    tr = _tiny_transformer()
    mb = MicroBatcher(tr, max_batch=4, max_wait_ms=10.0)
    try:
        for kw in (dict(mask=np.ones((PX, PX))), dict(strength=0.5)):
            with pytest.raises(ValueError, match="init_image"):
                mb.generate("x", n_iter=4, timeout=30, **kw)
        assert mb.queue_depth() == 0
    finally:
        mb.close()


def test_service_editing_rides_batcher():
    """The service sends an init_image request through the batcher."""
    svc = GenerationService(transformer=_tiny_transformer(), microbatch=4,
                            max_wait_ms=50.0)
    try:
        seen = []
        orig = svc.batcher.generate
        svc.batcher.generate = lambda *a, **kw: (seen.append(kw.get("init_image") is not None)
                                                 or orig(*a, **kw))
        buf = io.BytesIO()
        _images()[0].save(buf, "PNG")
        jpeg = svc.generate_jpeg(prompt="an oil painting", n_iter=4, strength=0.5,
                                 init_image=base64.b64encode(buf.getvalue()).decode())
        assert jpeg[:3] == b"\xff\xd8\xff"
        assert seen == [True], seen
    finally:
        svc.batcher.close()


def _gate(tr):
    """Hold the sampler until the returned event is set."""
    gate = threading.Event()
    orig = tr.diffuser.generate

    def gated(*a, **kw):
        gate.wait(30)
        return orig(*a, **kw)

    tr.diffuser.generate = gated
    return gate, orig


def _wait_depth(mb, n):
    for _ in range(400):
        if mb.queue_depth() == n:
            return
        time.sleep(0.01)


def test_microbatcher_backpressure_queue_full():
    """Once the images queued or in flight reach max_queue_imgs, generate()
    raises QueueFull at once; the budget comes back as requests finish."""
    tr = _tiny_transformer()
    gate, orig = _gate(tr)
    mb = MicroBatcher(tr, max_batch=1, max_wait_ms=5.0, max_queue_imgs=2)
    try:
        results, errors = [], []

        def run():
            try:
                results.append(mb.generate("x", n_iter=4, timeout=60))
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=run) for _ in range(2)]
        for t in threads:
            t.start()
        _wait_depth(mb, 2)  # one in flight, one queued
        assert mb.queue_depth() == 2
        with pytest.raises(QueueFull):
            mb.generate("overflow", n_iter=4)
        gate.set()
        for t in threads:
            t.join()
        assert not errors and len(results) == 2, errors
        assert mb.queue_depth() == 0
        assert isinstance(mb.generate("y", n_iter=4, timeout=60), PIL.Image.Image)
        assert mb.queue_depth() == 0
    finally:
        gate.set()
        mb.close()
        tr.diffuser.generate = orig


def test_microbatcher_backpressure_release_on_timeout_and_close():
    """A timed-out request and the close drain return their budget once."""
    tr = _tiny_transformer()
    gate, orig = _gate(tr)
    mb = MicroBatcher(tr, max_batch=2, max_wait_ms=5.0, max_queue_imgs=4)
    try:
        holder = threading.Thread(target=lambda: mb.generate("hold", n_iter=4, timeout=60))
        holder.start()
        _wait_depth(mb, 1)
        with pytest.raises(TimeoutError):
            mb.generate("late", n_iter=4, num_imgs=2, timeout=0.05)
        assert mb.queue_depth() == 3  # held until the worker skips it
        gate.set()
        holder.join()
        _wait_depth(mb, 0)
        assert mb.queue_depth() == 0
    finally:
        gate.set()
        mb.close()
        tr.diffuser.generate = orig
    assert mb.queue_depth() == 0


def test_wsgi_answers_a_full_queue_with_503_and_retry_after(monkeypatch):
    """The WSGI app answers QueueFull with a 503, a Retry-After header and
    the batcher's message; /healthz carries the queue fields."""
    import json

    from transformer_latent_diffusion_tpu_torch.serve.app import create_wsgi_app

    monkeypatch.setenv("API_TOKEN", "t")
    svc = GenerationService(transformer=_tiny_transformer(), microbatch=1,
                            max_wait_ms=5.0, max_queue_imgs=1)
    gate, orig = _gate(svc.transformer)
    app = create_wsgi_app(service=svc)

    def call(path, body=None):
        raw = b"" if body is None else json.dumps(body).encode()
        env = {"REQUEST_METHOD": "POST" if body else "GET", "PATH_INFO": path,
               "CONTENT_LENGTH": str(len(raw)), "wsgi.input": io.BytesIO(raw),
               "HTTP_AUTHORIZATION": "Bearer t"}
        seen = {}
        out = b"".join(app(env, lambda s, h: seen.update(status=int(s.split()[0]),
                                                          headers=dict(h))))
        return seen["status"], seen["headers"], out

    try:
        held = threading.Thread(target=lambda: call("/generate-image/",
                                                    {"prompt": "a", "n_iter": 4}))
        held.start()
        _wait_depth(svc.batcher, 1)
        status, headers, body = call("/generate-image/", {"prompt": "b", "n_iter": 4})
        assert status == 503 and int(headers["Retry-After"]) >= 1
        assert "queue full" in json.loads(body)["detail"]
        health = json.loads(call("/healthz")[2])
        assert health["queue_imgs"] == 1 and health["queue_limit"] == 1
        gate.set()
        held.join()
    finally:
        gate.set()
        svc.batcher.close()
        svc.transformer.diffuser.generate = orig


def test_service_settings_from_the_environment_and_warmup(monkeypatch):
    """SERVE_MICROBATCH / SERVE_MICROBATCH_MAX_QUEUE / SERVE_WARMUP set the
    batcher and the startup warm-up, as in the JAX service; the warm-up runs
    the default request once in a thread ("warming" until it is done) and
    counts no request."""
    monkeypatch.setenv("SERVE_MICROBATCH", "4")
    monkeypatch.setenv("SERVE_MICROBATCH_MAX_QUEUE", "12")
    monkeypatch.setenv("SERVE_WARMUP", "1")
    tr = _tiny_transformer()
    gate, orig = _gate(tr)
    svc = GenerationService(transformer=tr)
    try:
        assert svc.batcher.max_batch == 4 and svc.batcher.max_queue_imgs == 12
        assert svc.health()["status"] == "warming"
        gate.set()
        svc._warmup_thread.join(60)
        assert not svc._warmup_thread.is_alive()
        health = svc.health()
        assert health["status"] == "ok" and health["requests"] == 0
        assert svc.retry_after_hint() == 2  # no request served yet
    finally:
        gate.set()
        svc.batcher.close()
        tr.diffuser.generate = orig
