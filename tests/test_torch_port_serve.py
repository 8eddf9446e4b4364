"""The port's WSGI service on the CPU with tiny random weights: routes,
bearer auth, the text-to-image 422 checks, and the 422 that names the
ROADMAP item of a field the port does not serve yet."""

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
    ({"prompt": "x", "init_image": "abc"}, "ROADMAP item 9"),
    ({"prompt": "x", "best_of": 4}, "ROADMAP item 12"),
    ({"prompt": "x", "eta": 0.5, "sampler": "ddim"}, "ROADMAP item 9"),
    ({"prompt": "x", "cache_interval": 2}, "ROADMAP item 9"),
], ids=["no_prompt", "float_n_iter", "str_n_iter", "null_prompt", "bad_sampler",
        "editing", "best_of", "eta", "cache"])
def test_malformed_or_not_served_is_422(app, body, detail):
    status, _, out = call(app, "POST", "/generate-image/", body)
    assert status == 422
    assert detail in json.loads(out)["detail"]


def test_unknown_route_is_404_and_service_needs_a_device():
    status, _, _ = call(create_wsgi_app(service=object()), "GET", "/nowhere")
    assert status == 404
    with pytest.raises(ValueError, match="device"):
        GenerationService(pc.LTDConfig())


def test_default_config_runs_bf16():
    """With no config the service builds `default_config()`, whose bf16
    denoiser is what the CUDA kernels take; LTDConfig() itself keeps the
    JAX package's float32 default."""
    assert default_config().denoiser_load.dtype == "bfloat16"
    assert default_config().denoiser_cfg == pc.LTDConfig().denoiser_cfg
    assert pc.LTDConfig().denoiser_load.dtype == "float32"
