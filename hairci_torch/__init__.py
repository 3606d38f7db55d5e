"""hairci_torch -- the PyTorch/CUDA port of ``hairci`` for NVIDIA Hopper.

Same subpackage layout and module names as ``hairci/``, which stays the JAX
reference each module is tested against. This package imports ``torch`` and
never ``jax``; of ``hairci`` it imports only ``hairci.data`` (numpy/PIL).

Ported so far: the hair-retrieval serving path.
  aug/        to_float, normalize (uint8 NHWC at the public boundary)
  eval/       l2_normalize
  models/     ViT eval forward (vit.py) + JAX-param converter (convert.py)
  ops/        hand-written CUDA kernels (csrc/) with plain twins
  retrieval/  GalleryIndex, HairEncoder
  cli/        python -m hairci_torch.cli.retrieval
  serve/      python -m hairci_torch.serve.api
  utils/      device resolution
"""

__version__ = "0.1.0"
