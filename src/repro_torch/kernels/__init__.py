"""Attention for the port: plain PyTorch versions and Hopper CUDA kernels."""
