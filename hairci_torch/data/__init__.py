"""Manifests and the host-side image loader (the port's own copy of
``hairci/data``; numpy, pandas and PIL only)."""

from hairci_torch.data.loader import DataLoader, decode_image
from hairci_torch.data.manifest import Manifest, load_manifest

__all__ = ["DataLoader", "Manifest", "decode_image", "load_manifest"]
