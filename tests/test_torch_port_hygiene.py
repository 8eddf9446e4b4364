"""The port stands alone: it imports torch and never jax, flax, the JAX
package or `regex` (nor do chip_smoke.py and tests/test_torch_port_cuda.py, which run
on the card's machine, where jax is not installed), and its configs keep
the JAX package's field names and defaults, so one JSON config serves
both."""

import ast
import dataclasses
import json
import pathlib
import subprocess
import sys

import pytest

from transformer_latent_diffusion_tpu import configs as jax_configs
from transformer_latent_diffusion_tpu_torch import configs as port_configs

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "transformer_latent_diffusion_tpu_torch"
# regex: the JAX package's CLIP tokenizer needs it, the card's machine lacks it
FORBIDDEN = ("jax", "flax", "jaxlib", "transformer_latent_diffusion_tpu", "regex")


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import transformer_latent_diffusion_tpu_torch.sampling\n"
            "import transformer_latent_diffusion_tpu_torch.serve\n"
            "import transformer_latent_diffusion_tpu_torch.convert\n"
            "import transformer_latent_diffusion_tpu_torch.ops._build\n"
            "import transformer_latent_diffusion_tpu_torch.train\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_port_cuda.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


CONFIGS = ["DenoiserConfig", "DenoiserLoad", "VaeConfig", "ClipConfig",
           "ClipVisionConfig", "LTDConfig", "DataDownloadConfig", "DataConfig",
           "TrainConfig", "ModelConfig"]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_and_defaults_match_jax(name):
    jax_cls, port_cls = getattr(jax_configs, name), getattr(port_configs, name)
    jax_fields = {f.name: f for f in dataclasses.fields(jax_cls)}
    port_fields = {f.name: f for f in dataclasses.fields(port_cls)}
    assert list(port_fields) == list(jax_fields)
    jax_obj, port_obj = jax_cls(**_required(jax_cls)), port_cls(**_required(port_cls))
    assert port_configs.config_to_json(port_obj) == jax_configs.config_to_json(jax_obj)


def _required(cls):
    return {f.name: "x" for f in dataclasses.fields(cls)
            if f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING}


def test_ltd_config_json_crosses_packages(tmp_path):
    cfg = port_configs.LTDConfig(
        denoiser_cfg=port_configs.DenoiserConfig(embed_dim=768, n_layers=12),
        denoiser_load=port_configs.DenoiserLoad(dtype="bfloat16"),
        vae_cfg=port_configs.VaeConfig(block_out_channels=(8, 16)))
    path = tmp_path / "ltd.json"
    path.write_text(port_configs.config_to_json(cfg))
    back = jax_configs.ltd_config_from_json(str(path))
    assert json.loads(jax_configs.config_to_json(back)) == json.loads(path.read_text())
    assert port_configs.ltd_config_from_json(str(path)) == cfg
    assert port_configs.resolve_dtype(cfg.denoiser_load.dtype).is_floating_point


def test_model_config_json_crosses_packages(tmp_path):
    """A training config written by the port reads back in the JAX
    package with the same fields."""
    cfg = port_configs.ModelConfig(
        data_config=port_configs.DataConfig("l.npy", "t.npy", "v.npy"),
        denoiser_config=port_configs.DenoiserConfig(embed_dim=768, n_layers=12),
        train_config=port_configs.TrainConfig(batch_size=64, warmup_steps=10))
    want = json.loads(port_configs.config_to_json(cfg))
    back = jax_configs.ModelConfig(
        data_config=jax_configs.DataConfig(**want["data_config"]),
        denoiser_config=jax_configs.DenoiserConfig(**want["denoiser_config"]),
        train_config=jax_configs.TrainConfig(**want["train_config"]),
        vae_cfg=jax_configs.VaeConfig(**{k: tuple(v) if isinstance(v, list) else v
                                         for k, v in want["vae_cfg"].items()}),
        clip_cfg=jax_configs.ClipConfig(**want["clip_cfg"]))
    assert json.loads(jax_configs.config_to_json(back)) == want
