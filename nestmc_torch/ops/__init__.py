"""Obs-pass math: plain references (loglik), Cholesky algebra and the CUDA kernels."""
