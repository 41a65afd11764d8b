"""Hand-written CUDA kernels (sources in ``vit_tpu_torch/csrc``) and their plain PyTorch versions."""
