from transformer_latent_diffusion_tpu_torch.serve.app import (
    GenerationService,
    create_wsgi_app,
)

__all__ = ["GenerationService", "create_wsgi_app"]
