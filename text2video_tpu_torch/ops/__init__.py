"""Plain-PyTorch ops and wrappers of the hand-written CUDA kernels."""
