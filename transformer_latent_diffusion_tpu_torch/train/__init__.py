"""Training slice of the port (`train.main`)."""

from transformer_latent_diffusion_tpu_torch.train.train import (  # noqa: F401
    GracefulShutdown,
    build_loss_fn,
    eval_gen,
    main,
    make_grads_of,
    make_optimizer,
    resolve_fused_flags,
    sample_beta,
    train_step,
    update_ema,
)
