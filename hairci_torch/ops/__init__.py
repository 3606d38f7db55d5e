"""Hand-written CUDA kernels for Hopper with their plain PyTorch twins
(port of hairci.ops and of the two TPU kernels under tools/): ``topk``,
``rotate``, ``bn_stats`` and ``conv3x3``; and ``bn_apply``, BatchNorm's
apply and backward, which XLA fused in the JAX package. Kernels are built on
first use, never on import."""
