"""hairci_torch -- the PyTorch/CUDA port of ``hairci`` for NVIDIA Hopper.

Same subpackage layout and module names as ``hairci/``, which stays the JAX
reference each module is tested against. This package imports ``torch`` and
never ``jax``, and nothing of ``hairci``: ``data/`` and ``native/`` are its
own copies of the JAX-free loader and the C++ batch decoder.

Ported so far: hair-retrieval serving, SHAM training (ResNets and ViT-B/16,
with S2R2), and kNN evaluation.
  aug/        SimCLR/SHAM ops and pipelines, knn and test transforms
  data/       CSV manifests, the threaded loader (C++ decoder or PIL) and
              GrainLoader
  eval/       l2_normalize, extract_features, kNN, the report, Classifier
  losses/     NT-Xent, triplet, margin statistics, S2R2 (Smooth-AP)
  models/     ViT (eval and training forward), ResNets, BatchNorm, heads,
              converters
  native/     the C++ batch image decoder (g++ at first use)
  ops/        hand-written CUDA kernels (csrc/) with plain twins
  retrieval/  GalleryIndex, HairEncoder
  ssl/        recipe registry, SHAMRecipe
  train/      TrainState, optimizer, Trainer, checkpoints
  cli/        retrieval, mainpretrain, knn_classification
  serve/      python -m hairci_torch.serve.api
  utils/      device resolution, flags and YAML
"""

__version__ = "0.1.0"
