"""Host-side image loader (the port's copy of ``hairci/data/loader.py``).

Split of responsibilities, as in the JAX package:

  host threads : decode JPEG/PNG -> uint8, resize to one fixed raw shape
  device       : the whole random augmentation stack, batched

Host modes:
  - ``raw_resize``  (train): stretch-resize to (size, size) uint8; the
    device's random resized crop then samples from this square.
  - ``center_crop`` (eval): exact torchvision CenterCrop(size) semantics,
    zero-padding of smaller images included: the deterministic half of the
    kNN-parity contract.
  - ``resize_center_crop`` (retrieval encoders): torchvision Resize(size) on
    the shortest side, bicubic, then CenterCrop(size).

Decoders, as in the JAX package: ``decoder="auto"`` takes the C++ batch
decoder (``hairci_torch/native/imageio``) for ``raw_resize`` and
``center_crop`` and PIL for ``resize_center_crop``, and falls back to PIL,
with a warning, only when the library cannot be built; ``"native"`` raises
where the library cannot be built or the mode has no native path;
``"pil"`` forces PIL. The native decoder is bitwise PIL's in
``center_crop`` and within 2 LSB in ``raw_resize`` (float resampling
against Pillow's fixed-point coefficients).

Decode failures are logged and the sample is skipped, on both paths.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
from PIL import Image

from hairci_torch.data.manifest import Manifest
from hairci_torch.native import imageio
from hairci_torch.parallel.collectives import shard_for_host

log = logging.getLogger(__name__)

_NATIVE_MODES = {"raw_resize": imageio.MODE_RAW_RESIZE,
                 "center_crop": imageio.MODE_CENTER_CROP}


def _center_crop_uint8(arr: np.ndarray, size: int) -> np.ndarray:
    """torchvision CenterCrop parity on an (H, W, C) uint8 array."""
    h, w = arr.shape[:2]
    if h < size or w < size:
        ph, pw = max(size - h, 0), max(size - w, 0)
        arr = np.pad(arr, ((ph // 2, ph - ph // 2),
                           (pw // 2, pw - pw // 2), (0, 0)))
        h, w = arr.shape[:2]
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return arr[top:top + size, left:left + size]


def decode_image(path: str, mode: str, size: int) -> Optional[np.ndarray]:
    try:
        with Image.open(path) as im:
            im = im.convert("RGB")
            if mode == "raw_resize":
                im = im.resize((size, size), Image.BILINEAR)
                return np.asarray(im, dtype=np.uint8)
            if mode == "resize_center_crop":
                w, h = im.size
                if w <= h:
                    nw, nh = size, max(int(round(h * size / w)), size)
                else:
                    nh, nw = size, max(int(round(w * size / h)), size)
                im = im.resize((nw, nh), Image.BICUBIC)
                return _center_crop_uint8(np.asarray(im, dtype=np.uint8),
                                          size)
            arr = np.asarray(im, dtype=np.uint8)
        return _center_crop_uint8(arr, size)
    except Exception as e:  # noqa: BLE001 -- any decode failure is skippable
        log.warning("Failed to load image %s: %s", path, e)
        return None


class DataLoader:
    """Shuffling, prefetching batch loader over a Manifest.

    Yields (images (B, size, size, 3) uint8, labels (B,) int32). The
    incomplete final batch is dropped when ``drop_last``, and padded to the
    full batch size by repeating its last row when ``pad_last``.

    With ``shard_count`` > 1 (data parallelism) the batches stay those of
    the one-process run, in the same order, and this loader decodes and
    yields only its shard of each (``shard_for_host``'s rule: rows
    ``[i B/n, (i+1) B/n)`` for ``shard_index`` i of n): ``batch_size`` is the
    global batch, which n must divide, and the last batch must be dropped
    or padded so that every shard has its B/n rows.
    """

    def __init__(
        self,
        manifest: Manifest,
        batch_size: int,
        size: int = 224,
        mode: str = "raw_resize",
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 42,
        num_workers: int = 8,
        prefetch: int = 4,
        pad_last: bool = False,
        decoder: str = "auto",
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        if decoder not in ("auto", "native", "pil"):
            raise ValueError(f"unknown decoder {decoder!r}")
        if shard_count > 1 and (batch_size % shard_count
                                or not (drop_last or pad_last)):
            raise ValueError(
                f"a batch of {batch_size} split over {shard_count} shards "
                "must divide evenly, with the last batch dropped or padded")
        if decoder == "native":
            if mode not in _NATIVE_MODES:
                raise ValueError(
                    f"native decoder does not implement mode {mode!r}")
            if not imageio.available():
                raise RuntimeError("native image decoder unavailable: "
                                   + imageio.unavailable_reason())
        self.manifest = manifest
        self.batch_size = batch_size
        self.size = size
        self.mode = mode
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.pad_last = pad_last
        self.decoder = decoder
        self.shard_index = shard_index
        self.shard_count = shard_count
        self._epoch = 0

    def _native_decode(self, paths):
        """(images, ok-mask) from the C++ decoder, or None for the PIL
        path ("pil", a mode without a native path, or "auto" where the
        library cannot be built)."""
        native_mode = _NATIVE_MODES.get(self.mode)
        if self.decoder == "pil" or native_mode is None:
            return None
        return imageio.decode_batch(paths, self.size, native_mode,
                                    n_threads=max(self.num_workers, 1))

    def __len__(self) -> int:
        n = len(self.manifest)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.manifest))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx

    def _shard(self, indices: np.ndarray) -> np.ndarray:
        """This shard's rows of one batch of the one-process run, padded
        as that run pads it."""
        if self.pad_last and len(indices) < self.batch_size:
            indices = np.concatenate([indices, indices[-1:].repeat(
                self.batch_size - len(indices))])
        return indices[shard_for_host(len(indices), self.shard_index,
                                      self.shard_count)]

    def _load_batch(self, indices: np.ndarray, pool: ThreadPoolExecutor):
        paths = [self.manifest.paths[i] for i in indices]
        native = self._native_decode(paths)
        if native is not None:
            arrs, okmask = native
            good = [i for i in range(len(paths)) if okmask[i]]
            for i in range(len(paths)):
                if not okmask[i]:
                    log.warning("Failed to load image %s", paths[i])
        else:
            arrs = list(pool.map(
                lambda p: decode_image(p, self.mode, self.size), paths))
            good = [i for i, a in enumerate(arrs) if a is not None]
        if not good:
            return None
        images = np.stack([arrs[i] for i in good])
        labels = self.manifest.label_indices[indices[good]]
        target = (self.batch_size if self.pad_last and self.shard_count == 1
                  else len(indices))
        if images.shape[0] < target:
            # pad to a static shape by repeating rows (decode failures, or
            # the final partial batch when pad_last)
            pad = target - images.shape[0]
            images = np.concatenate([images, images[-1:].repeat(pad, 0)])
            labels = np.concatenate([labels, labels[-1:].repeat(pad)])
        return images, labels

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self._order()
        self._epoch += 1  # auto-advance (set_epoch overrides explicitly)
        n_batches = len(self)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_batches)]
        if self.shard_count > 1:
            batches = [self._shard(b) for b in batches]
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _SENTINEL = object()

        def producer():
            # the decode pool is used only from this thread (no nested
            # submits); num_workers=0 decodes with one worker
            with ThreadPoolExecutor(
                    max_workers=max(self.num_workers, 1)) as pool:
                for idxs in batches:
                    out_q.put(self._load_batch(idxs, pool))
            out_q.put(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = out_q.get()
            if item is _SENTINEL:
                break
            if item is not None:
                yield item
        t.join()
