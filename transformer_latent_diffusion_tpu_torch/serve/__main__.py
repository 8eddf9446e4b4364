"""`python -m transformer_latent_diffusion_tpu_torch.serve --device cuda
       [--host H] [--port P] [--config ltd.json]`

--config (or the SERVE_CONFIG environment variable) points at a
`config_to_json(LTDConfig(...))` file: weights, sizes and dtypes. Without
it the service runs `serve.app.default_config()` (bf16 denoiser); on CUDA
a config must set `denoiser_load.dtype` to "bfloat16"."""

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
