"""DualViewHair pair loader (port of ``hairci/experiments/dualview/data.py``,
the reference's ``simple_dataloader.py:13-74``): pairs ``{stem}.jpg`` (the
full image, the student's) with ``{stem}_hair.png`` (the hair crop, the
teacher's), both resized on the host; the student's crop, flip and jitter
are applied on the device by the caller.

Each pass over the loader shuffles with numpy's ``default_rng(seed +
epoch)`` and then counts the epoch up, as in JAX: a training run that draws
one batch before its first epoch (``train.train``) shuffles epoch e with
``seed + e + 1``.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np

from hairci_torch.data.loader import decode_image


def discover_pairs(root: str) -> List[Tuple[str, str]]:
    pairs = []
    for f in sorted(os.listdir(root)):
        if f.endswith("_hair.png"):
            stem = f[: -len("_hair.png")]
            for ext in (".jpg", ".jpeg", ".png"):
                full = os.path.join(root, stem + ext)
                if os.path.exists(full) and not full.endswith("_hair.png"):
                    pairs.append((full, os.path.join(root, f)))
                    break
    return pairs


class PairLoader:
    """Yields {"full": (B,S,S,3) uint8, "hair": (B,S,S,3) uint8} batches."""

    def __init__(self, root: str, batch_size: int = 32, size: int = 224,
                 shuffle: bool = True, seed: int = 42,
                 drop_last: bool = True):
        self.pairs = discover_pairs(root)
        if not self.pairs:
            raise FileNotFoundError(f"no (full, hair) pairs under {root}")
        self.batch_size = batch_size
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.pairs)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self) -> Iterator[dict]:
        idx = np.arange(len(self.pairs))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        for i in range(len(self)):
            sel = idx[i * self.batch_size:(i + 1) * self.batch_size]
            fulls, hairs = [], []
            for j in sel:
                fp, hp = self.pairs[j]
                f = decode_image(fp, "raw_resize", self.size)
                h = decode_image(hp, "raw_resize", self.size)
                if f is None or h is None:
                    continue
                fulls.append(f)
                hairs.append(h)
            if fulls:
                yield {"full": np.stack(fulls), "hair": np.stack(hairs)}
