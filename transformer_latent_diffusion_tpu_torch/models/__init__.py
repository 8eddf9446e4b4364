from transformer_latent_diffusion_tpu_torch.models.clip import ClipTextModel
from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import (
    FusedEngine,
    make_fused_apply,
)
from transformer_latent_diffusion_tpu_torch.models.vae import (
    AutoencoderKL,
    VaeDecoder,
)

__all__ = ["AutoencoderKL", "ClipTextModel", "Denoiser", "FusedEngine",
           "VaeDecoder", "make_fused_apply"]
