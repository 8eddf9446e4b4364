"""The port's WSGI service on the CPU with tiny random weights: routes,
bearer auth, the 422 checks (the JAX service's checks of the solver and
editing fields among them), the solver fields served, the 422 that names
the ROADMAP item of a field the port does not serve yet, and the 500s and
non-object bodies against the JAX WSGI app's answers. The editing
requests themselves: tests/test_torch_port_editing.py."""

import io
import json

import pytest
import torch

from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch.serve.app import (
    GenerationService,
    create_wsgi_app,
    default_config,
)

torch.set_num_threads(2)
TOKEN = "test-token"


@pytest.fixture(scope="module")
def app():
    cfg = pc.LTDConfig(
        vae_cfg=pc.VaeConfig(block_out_channels=(8, 16), layers_per_block=1),
        clip_cfg=pc.ClipConfig(width=64, heads=2, layers=2))
    return create_wsgi_app(cfg, device="cpu")


@pytest.fixture(autouse=True)
def api_token(monkeypatch):
    monkeypatch.setenv("API_TOKEN", TOKEN)


def call(app, method, path, body=None, token=TOKEN):
    raw = b"" if body is None else json.dumps(body).encode()
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "CONTENT_LENGTH": str(len(raw)), "wsgi.input": io.BytesIO(raw)}
    if token is not None:
        environ["HTTP_AUTHORIZATION"] = f"Bearer {token}"
    seen = {}

    def start_response(status, headers):
        seen["status"] = int(status.split()[0])
        seen["headers"] = dict(headers)

    out = b"".join(app(environ, start_response))
    return seen["status"], seen["headers"], out


def test_root_and_jpeg_generation(app):
    assert call(app, "GET", "/")[0] == 200
    before = app.service.health()["requests"]
    status, headers, body = call(app, "POST", "/generate-image/",
                                 {"prompt": "a cute cat", "n_iter": 3})
    assert status == 200 and headers["Content-Type"] == "image/jpeg"
    assert body[:3] == b"\xff\xd8\xff"
    # n_iter 3 snaps up to the 4-step bucket and says so
    assert headers["X-Effective-N-Iter"] == "4"
    health = json.loads(call(app, "GET", "/healthz")[2])
    assert health["requests"] == before + 1 and health["errors"] == 0
    assert health["backend"] == "cpu" and health["status"] == "ok"


@pytest.mark.parametrize("token,detail", [
    (None, "Not authenticated"), ("wrong", "Invalid authentication credentials")])
def test_bad_token_is_401(app, token, detail):
    status, headers, body = call(app, "POST", "/generate-image/",
                                 {"prompt": "x"}, token=token)
    assert status == 401 and headers["WWW-Authenticate"] == "Bearer"
    assert json.loads(body)["detail"] == detail


@pytest.mark.parametrize("body,detail", [
    ({}, "prompt is required"),
    ({"prompt": "x", "n_iter": 4.5}, "n_iter must be an integer"),
    ({"prompt": "x", "n_iter": "many"}, "n_iter must be an integer"),
    ({"prompt": None}, "prompt must not be null"),
    ({"prompt": "x", "sampler": "euler"}, "sampler must be one of"),
    ({"prompt": "x", "init_image": "abc", "seed_b": 3},
     "interpolate_to/seed_b do not compose with init_image"),
    ({"prompt": "x", "best_of": 4}, "ROADMAP item 12"),
    ({"prompt": "x", "eta": 1.5, "sampler": "ddim"}, "eta must be in [0, 1]"),
    ({"prompt": "x", "eta": 0.5, "sampler": "dpm"}, "requires sampler='ddim'"),
    ({"prompt": "x", "sampler": "heun", "cache_interval": 2},
     "cache_interval > 1 excludes sampler='heun'"),
    ({"prompt": "x", "cfg_rescale": 2}, "cfg_rescale must be in [0, 1]"),
], ids=["no_prompt", "float_n_iter", "str_n_iter", "null_prompt", "bad_sampler",
        "editing", "best_of", "eta", "eta_with_dpm", "cache", "cfg_rescale"])
def test_malformed_or_not_served_is_422(app, body, detail):
    status, _, out = call(app, "POST", "/generate-image/", body)
    assert status == 422
    assert detail in json.loads(out)["detail"]


@pytest.mark.parametrize("body", [
    {"sampler": "heun"}, {"sampler": "ddim", "eta": 0.5}, {"cfg_rescale": "0.7"},
    {"cache_interval": 2}], ids=["heun", "eta", "cfg_rescale", "cache_interval"])
def test_solver_fields_are_served(app, body):
    """The JAX service's solver fields answer 200 with a JPEG: heun, eta
    (with DDIM), cfg_rescale (a numeric string coerces, as pydantic's lax
    mode does) and block caching (on the CPU no engine: exact sampling,
    with the generator's warning)."""
    status, headers, out = call(app, "POST", "/generate-image/",
                                {"prompt": "a cute cat", "n_iter": 2, **body})
    assert status == 200 and headers["Content-Type"] == "image/jpeg"
    assert out[:3] == b"\xff\xd8\xff"


@pytest.mark.parametrize("path,token,status", [
    ("/generate-image/", None, 401), ("/generate-image/", "wrong", 401),
    ("/nowhere", TOKEN, 404)], ids=["no_token", "wrong_token", "unknown_route"])
def test_body_is_read_before_an_early_answer(path, token, status):
    """A POST answered before its body is parsed still has its body read
    whole: closing a socket with unread bytes resets the connection, which
    can cut the reply short on the client's side."""
    raw = json.dumps({"prompt": "x" * 1000}).encode()
    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": path,
               "CONTENT_LENGTH": str(len(raw)), "wsgi.input": io.BytesIO(raw)}
    if token is not None:
        environ["HTTP_AUTHORIZATION"] = f"Bearer {token}"
    seen = {}
    b"".join(create_wsgi_app(service=object())(
        environ, lambda s, h: seen.setdefault("status", int(s.split()[0]))))
    assert seen["status"] == status
    assert environ["wsgi.input"].tell() == len(raw)


def test_unknown_route_is_404_and_service_needs_a_device():
    status, _, _ = call(create_wsgi_app(service=object()), "GET", "/nowhere")
    assert status == 404
    with pytest.raises(ValueError, match="device"):
        GenerationService(pc.LTDConfig())


def test_default_config_runs_bf16():
    """With no config the service builds `default_config()`, which is
    `LTDConfig()`, the JAX service's default: a float32 denoiser (the
    kernels' float32 bodies on CUDA). bf16 is one config field away."""
    assert default_config() == pc.LTDConfig()
    assert default_config().denoiser_load.dtype == "float32"
    bf16 = pc.LTDConfig(denoiser_load=pc.DenoiserLoad(dtype="bfloat16"))
    assert bf16.denoiser_cfg == default_config().denoiser_cfg


class _FailingService:
    """A service whose generation raises, for both packages' frontends."""

    class transformer:  # noqa: N801 - the attribute the JAX app reads
        consistency = False

    def generate_jpeg(self, **kwargs):
        raise RuntimeError("the card is gone")

    def effective_n_iter(self, n_iter):
        return n_iter

    def health(self):
        return {}


def _raw_call(app, raw: bytes):
    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/generate-image/",
               "CONTENT_LENGTH": str(len(raw)), "wsgi.input": io.BytesIO(raw),
               "HTTP_AUTHORIZATION": f"Bearer {TOKEN}"}
    seen = {}

    def start_response(status, headers):
        seen["status"] = int(status.split()[0])

    out = b"".join(app(environ, start_response))
    return seen["status"], json.loads(out)


@pytest.mark.parametrize("raw", [
    b'{"prompt": "a cat"}', b"{not json", b"[1, 2]", b'["prompt"]', b'"text"',
    b"5", b"null"], ids=["generation_fails", "not_json", "list", "list_with_prompt",
                         "string", "number", "null"])
def test_500_and_non_object_bodies_answer_as_the_jax_app(raw):
    """A failing generation is a 500 with {"detail": str(e)}, and a body
    that is not a JSON object gets the JAX WSGI app's status and detail
    (a 500 with the parser's or the lookup's message, or the 422 of the
    prompt check), as the JAX frontend answers them."""
    from transformer_latent_diffusion_tpu.serve.app import create_wsgi_app as jax_app

    got = _raw_call(create_wsgi_app(service=_FailingService()), raw)
    want = _raw_call(jax_app(service=_FailingService()), raw)
    assert got == want
    if raw.startswith(b"{"):
        assert got[0] == 500
    if raw == b'{"prompt": "a cat"}':
        assert got == (500, {"detail": "the card is gone"})


class _RecordingTransformer:
    """A `transformer=` stand-in for both packages' services: records the
    keyword arguments of each text-to-image call and answers one image."""

    consistency = False
    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def generate_image_from_text(self, **kwargs):
        import PIL.Image

        self.calls.append(kwargs)
        return PIL.Image.new("RGB", (8, 8))


def _solver_values(calls):
    """(eta, cfg_rescale) of each recorded call; an absent knob is 0.0, as
    the JAX service leaves a snapped zero out of the call."""
    return [(kw.get("eta", 0.0), kw.get("cfg_rescale", 0.0)) for kw in calls]


@pytest.mark.parametrize("microbatch", [None, 4], ids=["direct", "batcher"])
@pytest.mark.parametrize("eta,cfg_rescale", [(0.1, 0.1), (0.3, 0.6), (0.9, 0.1)])
def test_eta_and_cfg_rescale_snap_to_quarters_as_the_jax_service(microbatch, eta,
                                                                  cfg_rescale):
    """The values of eta and cfg_rescale that reach the transformer (direct)
    or the micro-batcher's grouping key (batcher) are the JAX service's:
    snapped to quarters after the 422 checks."""
    from transformer_latent_diffusion_tpu.serve.app import GenerationService as JaxService
    from transformer_latent_diffusion_tpu.serve.app import create_wsgi_app as jax_app

    body = {"prompt": "a cat", "n_iter": 4, "sampler": "ddim", "eta": eta,
            "cfg_rescale": cfg_rescale}
    seen = {}
    for name, service_cls, make_app in (("jax", JaxService, jax_app),
                                        ("port", GenerationService, create_wsgi_app)):
        tr = _RecordingTransformer()
        svc = service_cls(transformer=tr, microbatch=microbatch, warmup=False)
        try:
            if microbatch:
                batched = []

                def record(*args, _log=batched, **kwargs):
                    _log.append(kwargs)
                    return tr.generate_image_from_text()
                svc.batcher.generate = record
            status, _, _ = call(make_app(service=svc), "POST", "/generate-image/", body)
        finally:
            if svc.batcher is not None:
                svc.batcher.close()
        assert status == 200, name
        seen[name] = _solver_values(batched if microbatch else tr.calls)
    want = [(round(eta * 4) / 4, round(cfg_rescale * 4) / 4)]
    assert seen["port"] == seen["jax"] == want
