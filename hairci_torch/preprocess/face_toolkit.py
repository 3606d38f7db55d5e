"""Offline hair-region extraction (port of
``hairci/preprocess/face_toolkit.py``; the reference's
``src/util/face_toolkit.py``): RetinaFace detection + FaRL/LaPa parsing ->
hair mask (class 10) -> the masked RGB image saved as ``<stem>_hair.png``
(black background), a folder at a time by a spawn pool whose workers each
load the models once.

facer is imported when the first mask is asked for, and its models run on
``device`` (default cuda; raises without a card unless the caller passes
``cpu``). Where facer is not installed, the mask is the documented Otsu
threshold of the luminance, as in the JAX package, and ``device`` is not
used: that threshold is numpy on the host.

CLI: python -m hairci_torch.preprocess.face_toolkit --input_dir raw/ --output_dir hair/
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
import os
from functools import partial
from typing import List, Optional

import numpy as np
from PIL import Image

from hairci_torch.utils.device import DeviceLike, resolve_device

log = logging.getLogger(__name__)

HAIR_CLASS = 10  # LaPa label for hair (the reference's `face_toolkit.py:44`)

_WORKER_MODELS = None  # one process's models, loaded on first use


def _init_models(device: DeviceLike = None):
    """(detector, parser) on ``device``, or () where facer is not
    installed; loaded once a process (a pool's worker loads its own)."""
    global _WORKER_MODELS
    if _WORKER_MODELS is not None:
        return _WORKER_MODELS
    try:
        import facer  # type: ignore
    except ImportError as e:
        log.warning("facer unavailable (%s); threshold fallback", e)
        _WORKER_MODELS = ()
        return _WORKER_MODELS
    dev = str(resolve_device(device))
    _WORKER_MODELS = (facer.face_detector("retinaface/mobilenet", device=dev),
                      facer.face_parser("farl/lapa/448", device=dev), dev)
    return _WORKER_MODELS


def hair_mask(image: np.ndarray,
              device: DeviceLike = None) -> Optional[np.ndarray]:
    """Boolean (H, W) hair mask of an RGB uint8 image, or None when facer
    finds no face."""
    models = _init_models(device)
    if models:
        import torch

        detector, parser, dev = models
        t = torch.from_numpy(image).permute(2, 0, 1)[None].to(dev)
        with torch.inference_mode():
            faces = detector(t)
            if len(faces.get("rects", [])) == 0:
                return None
            faces = parser(t, faces)
        seg = faces["seg"]["logits"].softmax(dim=1).argmax(dim=1)[0]
        return (seg == HAIR_CLASS).cpu().numpy()
    return luminance_mask(image)


def luminance_mask(image: np.ndarray) -> np.ndarray:
    """Otsu threshold of the luminance (robust to JPEG background
    artifacts, unlike a fixed cutoff)."""
    gray = image.astype(np.float32).mean(axis=-1)
    return gray > _otsu_threshold(gray)


def _otsu_threshold(gray: np.ndarray) -> float:
    hist, edges = np.histogram(gray.ravel(), bins=256, range=(0, 255))
    hist = hist.astype(np.float64)
    total = hist.sum()
    centers = (edges[:-1] + edges[1:]) / 2.0
    w0 = np.cumsum(hist)
    w1 = total - w0
    m0 = np.cumsum(hist * centers) / np.maximum(w0, 1e-12)
    m1 = (np.sum(hist * centers) - np.cumsum(hist * centers)) / np.maximum(
        w1, 1e-12)
    between = w0 * w1 * (m0 - m1) ** 2
    return float(centers[int(np.argmax(between))])


def process_face_image(path: str, output_dir: str,
                       device: DeviceLike = None) -> Optional[str]:
    """One image -> ``<stem>_hair.png``, the hair on a black background
    (the reference's `process_face_image`, `face_toolkit.py:22-58`); None
    for an unreadable image or one without a face."""
    try:
        with Image.open(path) as im:
            image = np.asarray(im.convert("RGB"))
    except OSError as e:
        log.warning("failed to read %s: %s", path, e)
        return None
    mask = hair_mask(image, device)
    if mask is None:
        log.info("no face in %s", path)
        return None
    out = image * mask[..., None].astype(np.uint8)
    stem = os.path.splitext(os.path.basename(path))[0]
    out_path = os.path.join(output_dir, f"{stem}_hair.png")
    Image.fromarray(out).save(out_path)
    return out_path


def process_folder_multiprocess(input_dir: str, output_dir: str,
                                num_workers: int = 4,
                                device: DeviceLike = None) -> List[str]:
    """Every image of ``input_dir`` through ``process_face_image``, in a
    spawn pool of ``num_workers`` (in this process for 1); returns the files
    written, in name order (the reference's `process_folder_multiprocess`,
    `face_toolkit.py:108-147`)."""
    os.makedirs(output_dir, exist_ok=True)
    paths = sorted(
        os.path.join(input_dir, f) for f in os.listdir(input_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
    worker = partial(process_face_image, output_dir=output_dir,
                     device=None if device is None else str(device))
    if num_workers <= 1:
        results = [worker(p) for p in paths]
    else:
        with mp.get_context("spawn").Pool(num_workers) as pool:
            results = pool.map(worker, paths)
    done = [r for r in results if r]
    log.info("processed %d/%d images", len(done), len(paths))
    return done


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device of facer's models (default cuda)")
    args = p.parse_args(argv)
    process_folder_multiprocess(args.input_dir, args.output_dir,
                                args.num_workers, args.device)


if __name__ == "__main__":
    main()
