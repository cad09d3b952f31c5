"""Sampling ops of the port: plain torch versions and CUDA kernels."""
