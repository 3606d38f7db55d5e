"""Retrieval encoders (port of ``hairci/retrieval/encoders.py``).

HairEncoder: ViT-B/16 trunk at 224 in bf16 (host Resize224 + CenterCrop224,
device ImageNet normalize); the feature is the final-normed CLS token,
L2-normalised. FaceEncoder: ``ViT_face`` (``VIT``) or ``ViTs_face``
(``VITs``) at 112 in bf16, the same host and device steps; the feature is
the model's LayerNorm-ed embedding, L2-normalised. API of both:
``extract_dataset_features`` (folder -> embeddings.npy + image_paths.txt),
``encode_single_image``, ``retrieve_similar_images``, ``feature_dim``.

Checkpoints load from ``.pth``/``.pt``: for HairEncoder timm-layout ViT keys
at the top level or under a common prefix, for FaceEncoder the reference's
``ViT_face`` layout. An Orbax checkpoint needs JAX: convert it with
``hairci.retrieval.torch_import.export_vit`` + ``save_torch_state_dict``.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hairci_torch.aug import ops
from hairci_torch.data.loader import decode_image
from hairci_torch.eval.features import l2_normalize
from hairci_torch.models.convert import (
    face_vit_state_dict,
    load_torch_state_dict,
    timm_vit_state_dict,
)
from hairci_torch.models.face_vit import build_vit_face
from hairci_torch.models.vit import build_vit
from hairci_torch.retrieval.index import GalleryIndex
from hairci_torch.utils.device import DeviceLike, resolve_device
from hairci_torch.utils.profiling import span

log = logging.getLogger(__name__)

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def list_image_folder(root: str) -> List[str]:
    """Recursive sorted listing (torchvision ImageFolder order)."""
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(IMAGE_EXTS):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


class _EncoderBase:
    """Subclasses set ``self.model`` (an ``nn.Module`` mapping NHWC float
    images to features) and ``img_size`` before calling this ``__init__``."""

    img_size: int = 224

    def __init__(self, ckpt_path: Optional[str], batch_size: int = 64,
                 device: DeviceLike = None):
        self.ckpt_path = ckpt_path
        self.batch_size = batch_size
        self.device = resolve_device(device)
        if ckpt_path and os.path.exists(str(ckpt_path)):
            self._load_checkpoint(ckpt_path)
        elif ckpt_path:
            log.warning("checkpoint %s not found; using random init",
                        ckpt_path)
        self.model = self.model.to(self.device).eval()

    @property
    def feature_dim(self) -> int:
        """Output embedding width (checked against imported galleries)."""
        m = self.model
        return int(getattr(m, "embed_dim", None) or getattr(m, "dim"))

    def _embed_fn(self, images: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _load_checkpoint(self, path: str) -> None:
        if not path.endswith((".pth", ".pt")):
            raise ValueError(
                f"{path}: only .pth/.pt checkpoints load without JAX; convert "
                "an Orbax checkpoint with hairci.retrieval.torch_import."
                "export_vit + save_torch_state_dict")
        self._load_torch(path)

    def _load_torch(self, path: str) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} has no torch-checkpoint converter")

    # -- host preprocessing (deterministic, exact) ----------------------
    def _preprocess(self, paths: Sequence[str]) -> np.ndarray:
        arrs = []
        for p in paths:
            a = decode_image(p, "resize_center_crop", self.img_size)
            if a is None:
                a = np.zeros((self.img_size, self.img_size, 3), np.uint8)
            arrs.append(a)
        return np.stack(arrs)

    @torch.no_grad()
    def extract_features(self, images: np.ndarray) -> np.ndarray:
        """(B, S, S, 3) uint8 -> (B, D) f32 L2-normalised features."""
        q, dev = len(images), self.device
        with span("embed.copy_in", q, dev):
            x = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
        with span("embed.forward", q, dev):
            out = l2_normalize(self._embed_fn(x).float())
        with span("embed.copy_out", q, dev):
            return out.cpu().numpy()

    # -- reference public API -------------------------------------------
    def extract_dataset_features(self, dataset_path: str, output_dir: str
                                 ) -> GalleryIndex:
        paths = list_image_folder(dataset_path)
        if not paths:
            raise FileNotFoundError(f"no images under {dataset_path}")
        feats = [self.extract_features(self._preprocess(
            paths[i:i + self.batch_size]))
            for i in range(0, len(paths), self.batch_size)]
        index = GalleryIndex(np.concatenate(feats), paths, normalized=True,
                             device=self.device)
        index.save(output_dir)
        log.info("saved %d embeddings to %s", len(index), output_dir)
        return index

    def load_embeddings(self, output_dir: str) -> GalleryIndex:
        return GalleryIndex.load(output_dir, device=self.device)

    def embeddings_exist(self, output_dir: str) -> bool:
        return GalleryIndex.exists(output_dir)

    def encode_single_image(self, image_path: str) -> np.ndarray:
        return self.extract_features(self._preprocess([image_path]))[0]

    def retrieve_similar_images(self, query_feature: np.ndarray,
                                index: GalleryIndex, top_k: int = 5
                                ) -> Tuple[List[str], np.ndarray]:
        scores, paths = index.search_paths(query_feature[None], top_k)
        return paths[0], scores[0]


class HairEncoder(_EncoderBase):
    img_size = 224

    def __init__(self, ckpt_path: Optional[str] = None,
                 model_name: str = "vit_base_patch16",
                 device: DeviceLike = None, batch_size: int = 64,
                 dtype: torch.dtype = torch.bfloat16):
        """Random weights come from ``torch.Generator().manual_seed(0)``
        (the same weights for every dtype and device); a checkpoint replaces
        them."""
        self.model = build_vit(
            model_name, img_size=self.img_size, global_pool=True, dtype=dtype,
            generator=torch.Generator().manual_seed(0))
        super().__init__(ckpt_path, batch_size, device)

    def _embed_fn(self, images: torch.Tensor) -> torch.Tensor:
        # host already did resize + center-crop; device does float+normalize
        x = ops.normalize(ops.to_float(images))
        # CLS of the final-normed tokens, not the global-pool mean
        return self.model(x)[:, 0]

    def _load_torch(self, path: str) -> None:
        """Non-strict import like the reference (`hair_encoder.py:53-76`):
        timm-layout ViT keys at the top level or under common prefixes."""
        sd = load_torch_state_dict(path)
        for prefix in ("", "backbone.vit.", "vit.", "module."):
            trial = {k[len(prefix):]: v for k, v in sd.items()
                     if k.startswith(prefix)}
            if "cls_token" in trial and "blocks.0.attn.qkv.weight" in trial:
                self.model.load_state_dict(
                    timm_vit_state_dict(trial, self.model), strict=True)
                log.info("loaded torch ViT weights (prefix=%r)", prefix)
                return
        raise ValueError(f"{path}: no recognizable ViT layout")


class FaceEncoder(_EncoderBase):
    img_size = 112

    def __init__(self, ckpt_path: Optional[str] = None,
                 model_name: str = "VIT", device: DeviceLike = None,
                 batch_size: int = 64, dtype: torch.dtype = torch.bfloat16):
        """``model_name``: ``VIT`` or ``VITs``. Random weights come from
        ``torch.Generator().manual_seed(0)``, as HairEncoder's."""
        self.model = build_vit_face(
            model_name, dtype=dtype,
            generator=torch.Generator().manual_seed(0))
        super().__init__(ckpt_path, batch_size, device)

    def _embed_fn(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(ops.normalize(ops.to_float(images)))

    def _load_torch(self, path: str) -> None:
        self.model.load_state_dict(
            face_vit_state_dict(load_torch_state_dict(path), self.model),
            strict=True)
        log.info("loaded torch ViT_face weights from %s", path)
