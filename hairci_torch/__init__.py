"""hairci_torch -- the PyTorch/CUDA port of ``hairci`` for NVIDIA Hopper.

Same subpackage layout and module names as ``hairci/``, which stays the JAX
reference each module is tested against. This package imports ``torch`` and
never ``jax``, and nothing of ``hairci``: ``data/`` and ``native/`` are its
own copies of the JAX-free loader and the C++ batch decoder.

Ported so far: hair- and face-retrieval serving (the CLIs, the HTTP API,
FAISS flat-index import, the host flat index, the demo, the visualizer),
offline preprocessing, SHAM training (ResNets and ViT-B/16, with S2R2),
SimCLR and SupCon, the masked-image recipes MAE and SimMIM, and evaluation.
  aug/        SimCLR/SHAM/MAE ops and pipelines, knn and test transforms
  data/       CSV manifests, the threaded loader (C++ decoder or PIL) and
              GrainLoader
  eval/       l2_normalize, extract_features, kNN, the linear probe, the 2-D
              projection, the variance, the report, Classifier
  losses/     NT-Xent, triplet, margin statistics, S2R2 (Smooth-AP), SupCon,
              the reconstruction losses and UniGrad
  models/     ViT (eval and training forward, token masking), the face ViT
              and its margin heads, ResNets, BatchNorm, heads, token masks,
              converters
  native/     the C++ batch image decoder and the host flat index (g++ at
              first use)
  ops/        hand-written CUDA kernels (csrc/) with plain twins
  parallel/   the (data, model) mesh over a torch.distributed process group
              and the collectives of data-parallel training
  preprocess/ hair-region extraction (facer, or the Otsu threshold) and the
              folder splitter
  retrieval/  GalleryIndex, the row-sharded gallery search, HairEncoder,
              FaceEncoder, FAISS flat-index files
  ssl/        recipe registry, SHAM, SimCLR, SupCon, MAE, SimMIM
  train/      TrainState, optimizer, Trainer, checkpoints
  cli/        retrieval, face_retrieval, mainpretrain, knn_classification
  serve/      the HTTP API, the demo and the result visualizer
  utils/      device resolution, flags and YAML, seeding, profiling, and
              the hot path's spans (``profiling.span``; on only while a
              profiler runs, read by ``profiling.spans()``)
"""

__version__ = "0.1.0"
