"""vit_tpu_torch: the PyTorch/CUDA port of vit_tpu for one NVIDIA H100.

It imports torch and never jax. Each module keeps the module path and class
names of its counterpart in ``vit_tpu``; the JAX package is the reference the
port is tested against.
"""

__version__ = "0.1.0"
