"""`python -m transformer_latent_diffusion_tpu_torch.serve --device cuda
       [--host H] [--port P] [--config ltd.json]`

--config (or the SERVE_CONFIG environment variable) points at a
`config_to_json(LTDConfig(...))` file: weights, sizes and dtypes. Without
it the service runs `serve.app.default_config()`, `LTDConfig()` (a float32
denoiser, the kernels' float32 bodies on CUDA), as the JAX service does.
The SERVE_* environment variables set the micro-batcher (SERVE_MICROBATCH,
SERVE_MICROBATCH_WAIT_MS, SERVE_MICROBATCH_MAX_QUEUE), the buckets, the
request timeout and the startup warm-up (SERVE_WARMUP)."""

import argparse
import os

from transformer_latent_diffusion_tpu_torch.configs import ltd_config_from_json
from transformer_latent_diffusion_tpu_torch.serve.app import serve

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", required=True,
                    help='torch device to serve on, e.g. "cuda" or "cpu"')
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--config", default=os.getenv("SERVE_CONFIG"),
                    help="LTDConfig JSON (configs.ltd_config_from_json)")
    args = ap.parse_args()
    cfg = ltd_config_from_json(args.config) if args.config else None
    serve(cfg=cfg, device=args.device, host=args.host, port=args.port)
