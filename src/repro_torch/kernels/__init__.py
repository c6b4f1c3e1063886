"""Kernels of the port: hand-written CUDA for Hopper, each beside its plain
PyTorch version in ``ref``; ``ops`` chooses by the tensors' device."""
