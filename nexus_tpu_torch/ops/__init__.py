"""Tensor ops of the port: norms, RoPE, attention (CUDA flash kernels),
losses, remat."""
