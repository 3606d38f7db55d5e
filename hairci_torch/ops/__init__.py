"""Hand-written CUDA kernels for Hopper with their plain PyTorch twins
(port of hairci.ops and of the two TPU kernels under tools/): ``topk``,
``rotate``, ``bn_stats`` and ``conv3x3``. Kernels are built on first use,
never on import."""
