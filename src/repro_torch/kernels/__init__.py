"""Kernels of the port that replace the JAX package's Pallas kernels:
each module holds the CUDA wrapper and its plain PyTorch version."""
