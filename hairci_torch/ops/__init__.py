"""Hand-written CUDA kernels for Hopper with their plain PyTorch twins
(port of hairci.ops). Kernels are built on first use, never on import."""
