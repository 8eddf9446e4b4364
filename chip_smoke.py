"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of the fused decoder layer from
`transformer_latent_diffusion_tpu_torch/csrc/`, holds each against its
plain PyTorch version at the main path's shapes, holds one fused-engine
forward against the plain bf16 forward, drives the library entry point
(32 images, 50-step DDIM, CFG 6, flagship 101M denoiser, random weights
from a seed) and the HTTP service on a real socket, and checks that the
main path's run launched every kernel. Any failure raises: there is no
CPU fallback and no caught phase.

Output: one line per phase; then the card's name and power limit as
nvidia-smi reports them, one JSON line with the kernels' launches,
errors and times, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import torch

# main-path shapes: CFG doubles batch 32 to 64; 16x16 tokens; flagship width
B, HW, D, HEADS = 64, 16, 768, 12
N, HIDDEN = HW * HW, 4 * 768
N_IMGS, N_ITER = 32, 50
DEVICE = "cuda"
TPU_KERNEL = "transformer_latent_diffusion_tpu/ops/fused_stack.py:59"
# kernel vs plain version on the same inputs: rel-L2 and max-abs bounds
# (max-abs relative to the plain output's largest magnitude). The two
# accumulate the same bf16 products in float32 in different orders, so a
# bf16 output may differ by one rounding step (2^-8 relative).
KERNEL_REL_L2 = 1e-2
KERNEL_MAX_ABS = 2e-2
# one whole decoder layer, kernels vs the plain stack, rel-L2 of the layer's
# update: the one-step flips of the intermediate bf16 roundings propagate
# into the bf16 output, so a looser bound than for a single kernel
LAYER_REL_L2 = 2e-2
# one fused-engine forward vs the plain bf16 forward (rel-L2): measured
# 0.0106 on an H100 80GB HBM3 at 700 W (random flagship weights, batch 64);
# the bound leaves about 3x margin
ENGINE_REL_L2 = 0.03


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_env():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke runs "
                           "on a CUDA GPU only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"devices {torch.cuda.device_count()} | matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from transformer_latent_diffusion_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    secs = time.perf_counter() - t0
    log(f"[build] {path} in {secs:.1f} s")
    name = "?"
    for line in (path.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line:
            log(f"[build]   {name}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            log(f"[build]   {name}: {line.strip()}")


def _errors(out, ref):
    scale = float(ref.abs().max())
    err = float((out.float() - ref.float()).abs().max())
    return rel_l2(out.float(), ref.float()), err, err / max(scale, 1e-30)


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes."""
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

    dev = torch.device(DEVICE)
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * std).to(dev, dtype)

    m = B * N
    x = randn(m, D)
    ln = (1.0 + randn(D, std=0.1), randn(D, std=0.1))
    wqkv = randn(3 * D, D, std=D ** -0.5, dtype=torch.bfloat16)
    w1 = randn(HIDDEN, D, std=D ** -0.5, dtype=torch.bfloat16)
    b1 = randn(HIDDEN, std=0.1)
    wq = randn(D, D, std=D ** -0.5, dtype=torch.bfloat16)
    wkv = randn(2 * D, D, std=D ** -0.5, dtype=torch.bfloat16)
    w2 = randn(D, HIDDEN, std=HIDDEN ** -0.5, dtype=torch.bfloat16)
    b2 = randn(D, std=0.1)
    act = randn(m, HIDDEN, dtype=torch.bfloat16)
    xn = randn(m, D, dtype=torch.bfloat16)  # LN3 rows, as cross_attention writes them
    cond = randn(2 * B, D, dtype=torch.bfloat16)
    qkv = randn(m, 3 * D, dtype=torch.bfloat16)
    qc = randn(m, D, dtype=torch.bfloat16)
    kv = randn(2 * B, 2 * D, dtype=torch.bfloat16)
    hmat = randn(m, HIDDEN, dtype=torch.bfloat16)
    dw = randn(9, HIDDEN, std=1 / 3, dtype=torch.bfloat16)
    dwb = randn(HIDDEN, std=0.1)

    gemm_cases = [  # (name, kernel call, plain call); residual cases compare x' - x
        ("qkv", lambda: fs.ln_gemm(x, wqkv, ln=ln),
         lambda: fs.ln_gemm_plain(x, wqkv, ln=ln)),
        ("q", lambda: fs.ln_gemm(x, wq, ln=ln),
         lambda: fs.ln_gemm_plain(x, wq, ln=ln)),
        ("kv", lambda: fs.ln_gemm(cond, wkv), lambda: fs.ln_gemm_plain(cond, wkv)),
        ("kv_ragged", lambda: fs.ln_gemm(cond[:4].contiguous(), wkv),
         lambda: fs.ln_gemm_plain(cond[:4], wkv)),
        ("expand", lambda: fs.ln_gemm(xn, w1, bias=b1),
         lambda: fs.ln_gemm_plain(xn, w1, bias=b1)),
        ("contract", lambda: fs.ln_gemm(act, w2, bias=b2, residual=x.clone()) - x,
         lambda: fs.ln_gemm_plain(act, w2, bias=b2, residual=x) - x),
    ]
    results = {}
    worst = {}
    for name, kern, plain in gemm_cases:
        r, a, rel_a = _errors(kern(), plain())
        log(f"[kernels] ln_gemm/{name}: rel-L2 {r:.2e} max-abs {a:.3e} "
            f"({rel_a:.2e} of max |ref|)")
        if not (r < KERNEL_REL_L2 and rel_a < KERNEL_MAX_ABS):
            raise AssertionError(f"ln_gemm/{name} disagrees with its plain version")
        worst["ln_gemm"] = max(worst.get("ln_gemm", 0.0), a)
    # each product alone, then the five of one layer together
    xr = x.clone()
    flops = {"qkv": (m, 3 * D, D), "q": (m, D, D), "kv": (2 * B, 2 * D, D),
             "expand": (m, HIDDEN, D), "contract": (m, D, HIDDEN)}
    alone = {"qkv": lambda: fs.ln_gemm(x, wqkv, ln=ln),
             "q": lambda: fs.ln_gemm(x, wq, ln=ln),
             "kv": lambda: fs.ln_gemm(cond, wkv),
             "expand": lambda: fs.ln_gemm(xn, w1, bias=b1),
             "contract": lambda: fs.ln_gemm(act, w2, bias=b2, residual=xr)}
    for name, fn in alone.items():
        ms = time_ms(fn)
        mm, nn, kk = flops[name]
        log(f"[kernels] ln_gemm/{name} ({mm}x{nn}x{kk}): {ms:.4f} ms, "
            f"{2 * mm * nn * kk / ms / 1e9:.1f} TFLOP/s")
    layer_gemm = lambda: (fs.ln_gemm(x, wqkv, ln=ln), fs.ln_gemm(x, wq, ln=ln),  # noqa: E731
                          fs.ln_gemm(cond, wkv), fs.ln_gemm(xn, w1, bias=b1),
                          fs.ln_gemm(act, w2, bias=b2, residual=xr))
    layer_gemm_plain = lambda: (  # noqa: E731
        fs.ln_gemm_plain(x, wqkv, ln=ln), fs.ln_gemm_plain(x, wq, ln=ln),
        fs.ln_gemm_plain(cond, wkv), fs.ln_gemm_plain(xn, w1, bias=b1),
        fs.ln_gemm_plain(act, w2, bias=b2, residual=x))
    results["ln_gemm"] = (layer_gemm, layer_gemm_plain)

    def updates(outs):
        return torch.cat([(outs[0] - x).flatten(), outs[1].float().flatten()])

    cases = {
        "self_attention": (
            lambda: fs.self_attention(qkv, x.clone(), HEADS, N) - x,
            lambda: fs.self_attention_plain(qkv, x, HEADS, N) - x,
            lambda: fs.self_attention(qkv, xr, HEADS, N),
            lambda: fs.self_attention_plain(qkv, x, HEADS, N)),
        # both outputs: the residual's update and the LN3 rows
        "cross_attention": (
            lambda: updates(fs.cross_attention(qc, kv, x.clone(), ln, HEADS, N)),
            lambda: updates(fs.cross_attention_plain(qc, kv, x, ln, HEADS, N)),
            lambda: fs.cross_attention(qc, kv, xr, ln, HEADS, N),
            lambda: fs.cross_attention_plain(qc, kv, x, ln, HEADS, N)),
        "dwconv_gelu": (
            lambda: fs.dwconv_gelu(hmat, dw, dwb, HW),
            lambda: fs.dwconv_gelu_plain(hmat, dw, dwb, HW),
            lambda: fs.dwconv_gelu(hmat, dw, dwb, HW),
            lambda: fs.dwconv_gelu_plain(hmat, dw, dwb, HW)),
    }
    # one whole layer: the four kernels against the plain stack
    params = {f"denoiser_trans_block.decoder_blocks.0.{k}": v for k, v in {
        "norm1.weight": ln[0], "norm1.bias": ln[1], "norm2.weight": ln[0],
        "norm2.bias": ln[1], "norm3.weight": ln[0], "norm3.bias": ln[1],
        "self_attention.qkv_linear.weight": wqkv, "cross_attention.q_linear.weight": wq,
        "cross_attention.kv_linear.weight": wkv, "mlp.mlp.0.weight": w1[:, :, None, None],
        "mlp.mlp.0.bias": b1, "mlp.mlp.1.weight": dw.T.reshape(HIDDEN, 1, 3, 3),
        "mlp.mlp.1.bias": dwb, "mlp.mlp.3.weight": w2[:, :, None, None],
        "mlp.mlp.3.bias": b2}.items()}
    stack = fs.pack_layer_stack(params, [0], torch.bfloat16)
    xb = x.reshape(B, N, D).to(torch.bfloat16)
    cb = cond.reshape(B, 2, D)
    got = fs.fused_layer_stack(xb, cb, stack, HW, HEADS).float() - xb.float()
    want = fs.fused_layer_stack_plain(xb, cb, stack, HW, HEADS).float() - xb.float()
    r = rel_l2(got, want)
    log(f"[kernels] one decoder layer, kernels vs fused_layer_stack_plain: rel-L2 of the "
        f"layer's update {r:.2e} (bound {LAYER_REL_L2})")
    if not r < LAYER_REL_L2:
        raise AssertionError("the kernels' decoder layer disagrees with the plain stack")

    for name, (kern, plain, kern_t, plain_t) in cases.items():
        r, a, rel_a = _errors(kern(), plain())
        log(f"[kernels] {name}: rel-L2 {r:.2e} max-abs {a:.3e} "
            f"({rel_a:.2e} of max |ref|)")
        if not (r < KERNEL_REL_L2 and rel_a < KERNEL_MAX_ABS):
            raise AssertionError(f"{name} disagrees with its plain version")
        worst[name] = a
        results[name] = (kern_t, plain_t)
    torch.cuda.synchronize()

    timing = {}
    for name, (kern, plain) in results.items():
        # plain, kernel, kernel, plain: the medians of each side
        p1 = time_ms(plain)
        k1 = time_ms(kern)
        k2 = time_ms(kern)
        p2 = time_ms(plain)
        timing[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"[kernels] {name}: {timing[name][0]:.4f} ms per layer, plain "
            f"{timing[name][1]:.4f} ms (kernel runs {k1:.4f}/{k2:.4f}, plain "
            f"{p1:.4f}/{p2:.4f})")
    return worst, timing


def flagship_configs():
    from transformer_latent_diffusion_tpu_torch.configs import (
        ClipConfig,
        DenoiserConfig,
        DenoiserLoad,
        LTDConfig,
        VaeConfig,
    )

    den = DenoiserConfig(image_size=32, noise_embed_dims=256, patch_size=2,
                         embed_dim=768, dropout=0, n_layers=12)
    return LTDConfig(denoiser_cfg=den, denoiser_load=DenoiserLoad(dtype="bfloat16"),
                     vae_cfg=VaeConfig(), clip_cfg=ClipConfig())


def phase_engine(cfg):
    """One fused-engine forward vs the plain bf16 Denoiser forward."""
    from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
    from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import (
        make_fused_apply,
    )
    from transformer_latent_diffusion_tpu_torch.utils.common import (
        init_random_weights_,
    )

    dev = torch.device(DEVICE)
    model = Denoiser.from_config(cfg.denoiser_cfg, dtype=torch.bfloat16)
    init_random_weights_(model, 0)
    model.to(dev).eval()
    g = torch.Generator(device="cpu").manual_seed(1)
    size = cfg.denoiser_cfg.image_size
    x = torch.randn(B, 4, size, size, generator=g).to(dev)
    noise = torch.full((B, 1), 0.5, device=dev)
    label = torch.randn(B, cfg.denoiser_cfg.text_emb_size, generator=g).to(dev)
    engine = make_fused_apply(cfg.denoiser_cfg, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        prepared = engine.prepare(model.state_dict())
        out = engine.apply_prepared(prepared, x, noise, label)
        ref = model(x, noise, label)
    torch.cuda.synchronize()
    r = rel_l2(out, ref)
    cos = float(torch.nn.functional.cosine_similarity(
        out.double().flatten(), ref.double().flatten(), dim=0))
    log(f"[engine] fused engine vs plain bf16 forward, batch {B}: rel-L2 {r:.5f} "
        f"(bound {ENGINE_REL_L2}), cos {cos:.6f}")
    if not (torch.isfinite(out).all() and r < ENGINE_REL_L2):
        raise AssertionError("fused engine disagrees with the plain forward")
    with torch.no_grad():
        t_eng = time_ms(lambda: engine.apply_prepared(prepared, x, noise, label), 5, 2)
        t_ref = time_ms(lambda: model(x, noise, label), 5, 2)
    log(f"[engine] one forward at batch {B}: fused {t_eng:.3f} ms, plain bf16 "
        f"{t_ref:.3f} ms")
    del model, prepared


def phase_library(cfg):
    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
    from transformer_latent_diffusion_tpu_torch.sampling import DiffusionTransformer

    t0 = time.perf_counter()
    tr = DiffusionTransformer(cfg, device=DEVICE, seed=0)
    torch.cuda.synchronize()
    log(f"[library] DiffusionTransformer built in {time.perf_counter() - t0:.1f} s")
    latents = []
    tr.vae.post_quant_conv.register_forward_pre_hook(
        lambda mod, args: latents.append(args[0].detach()))

    def run():
        return tr.generate_array_from_text("a cute cat", num_imgs=N_IMGS,
                                           n_iter=N_ITER, sampler="ddim",
                                           class_guidance=6)

    t0 = time.perf_counter()
    run()  # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    latents.clear()
    fs.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fs.LAUNCHES)
    px = 8 * cfg.denoiser_cfg.image_size
    if imgs.shape != (N_IMGS, px, px, 3) or imgs.dtype.name != "uint8":
        raise AssertionError(f"images {imgs.shape} {imgs.dtype}")
    if len(latents) != 1 or not torch.isfinite(latents[0]).all():
        raise AssertionError("decoded latents missing or not finite")
    if float(imgs.std()) <= 0:
        raise AssertionError("images are constant")
    calls = N_ITER  # n_iter - 1 update steps + the final denoise
    expect = {k: v * cfg.denoiser_cfg.n_layers * calls
              for k, v in fs.LAUNCHES_PER_LAYER.items()}
    log(f"[library] generate_array_from_text {N_IMGS} imgs x {N_ITER} DDIM steps: "
        f"{wall:.3f} s ({N_IMGS / wall:.3f} imgs/s; warm-up run {warm:.1f} s); "
        f"launches {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != expected {expect}")
    return tr, launches


def phase_serving(tr):
    from wsgiref.simple_server import WSGIRequestHandler, make_server

    from transformer_latent_diffusion_tpu_torch.serve.app import (
        GenerationService,
        create_wsgi_app,
    )

    class QuietHandler(WSGIRequestHandler):
        def log_message(self, *args):
            pass

    os.environ["API_TOKEN"] = "smoke-token"
    app = create_wsgi_app(service=GenerationService(transformer=tr))
    server = make_server("127.0.0.1", 0, app, handler_class=QuietHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        def request(path, body=None, token="smoke-token"):
            headers = {"Content-Type": "application/json"}
            if token:
                headers["Authorization"] = f"Bearer {token}"
            data = None if body is None else json.dumps(body).encode()
            req = urllib.request.Request(base + path, data=data, headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=600) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        status, _ = request("/")
        if status != 200:
            raise AssertionError(f"GET / -> {status}")
        times = []
        for i in range(3):
            t0 = time.perf_counter()
            status, body = request("/generate-image/", {"prompt": f"a cute cat {i}"})
            times.append(time.perf_counter() - t0)
            if status != 200 or not body.startswith(b"\xff\xd8\xff"):
                raise AssertionError(f"POST /generate-image/ -> {status} {body[:200]!r}")
        status, _ = request("/generate-image/", {"prompt": "x"}, token=None)
        if status != 401:
            raise AssertionError(f"POST without a token -> {status}, expected 401")
        status, body = request("/healthz")
        health = json.loads(body)
        if status != 200 or health["requests"] != 3 or health["errors"] != 0:
            raise AssertionError(f"/healthz -> {status} {health}")
        log(f"[serving] GET / 200; 3 x POST /generate-image/ (defaults: 1 image, "
            f"15-step DPM++) 200 JPEG in {', '.join(f'{t:.3f}' for t in times)} s; "
            f"no token 401; /healthz {health['requests']} requests on "
            f"{health['device_kind']}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def main():
    smi = phase_env()
    phase_build()
    worst, timing = phase_kernels()
    cfg = flagship_configs()
    phase_engine(cfg)
    torch.cuda.empty_cache()
    tr, launches = phase_library(cfg)
    phase_serving(tr)

    from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs

    kernels = []
    for name in fs.KERNELS:
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"transformer_latent_diffusion_tpu_torch/csrc/{name}.cu",
            "replaces": TPU_KERNEL, "launches": launches[name],
            "max_abs_err": worst[name], "ms": timing[name][0],
            "plain_ms": timing[name][1],
        })
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
