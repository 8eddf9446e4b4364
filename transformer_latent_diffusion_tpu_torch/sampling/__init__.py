from transformer_latent_diffusion_tpu_torch.sampling.diffusion import (
    DiffusionGenerator,
)
from transformer_latent_diffusion_tpu_torch.sampling.pipeline import (
    DiffusionTransformer,
)

__all__ = ["DiffusionGenerator", "DiffusionTransformer"]
