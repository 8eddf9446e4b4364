"""PyTorch and CUDA port of transformer_latent_diffusion_tpu, for NVIDIA Hopper.

The module names mirror the JAX package's, so each module's counterpart is
found under the same path. The port imports torch and never jax; the
decoder layers of the fused inference engine run as hand-written CUDA
kernels (`csrc/`, built at first use by `ops/_build.py`).
"""
