"""The CUDA kernels' wrappers (built from ``csrc/`` at first launch), their
plain PyTorch versions and the mode policy."""
