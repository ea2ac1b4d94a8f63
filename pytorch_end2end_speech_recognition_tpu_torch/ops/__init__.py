"""Kernels (CUDA, built from csrc/) with their plain PyTorch versions."""
