"""dpft_tpu_torch: the DPFT port to PyTorch and CUDA for NVIDIA Hopper.

Counterpart of the JAX package ``dpft_tpu``; it imports torch and never jax.
"""

__version__ = "0.1.0"
