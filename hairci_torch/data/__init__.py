"""Manifests and the host-side image loaders (the port's own copy of
``hairci/data``): the threaded ``DataLoader`` with its C++ and PIL decode
routes, and ``GrainLoader``, which imports grain only when it is made."""

from hairci_torch.data.grain_loader import GrainLoader
from hairci_torch.data.loader import DataLoader, decode_image
from hairci_torch.data.manifest import Manifest, load_manifest

__all__ = ["DataLoader", "GrainLoader", "Manifest", "decode_image",
           "load_manifest"]
