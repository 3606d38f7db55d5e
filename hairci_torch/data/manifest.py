"""CSV manifest reading (the port's copy of ``hairci/data/manifest.py``): a
CSV with columns (id, class) where id is an image filename under
``img_dir``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np
import pandas as pd


@dataclasses.dataclass
class Manifest:
    paths: List[str]          # absolute image paths
    labels: np.ndarray        # (N,) int64 raw class ids
    class_names: List         # sorted unique raw labels
    label_indices: np.ndarray  # (N,) int32 contiguous [0, C)

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def num_classes(self) -> int:
        return len(self.class_names)


def load_manifest(annotations_file: str, img_dir: str) -> Manifest:
    df = pd.read_csv(annotations_file)
    names = df.iloc[:, 0].astype(str).tolist()
    labels = df.iloc[:, 1].to_numpy()
    paths = [os.path.join(img_dir, n) for n in names]
    classes = sorted(set(labels.tolist()))
    lut = {c: i for i, c in enumerate(classes)}
    label_idx = np.asarray([lut[l] for l in labels.tolist()], dtype=np.int32)
    return Manifest(paths=paths, labels=labels, class_names=classes,
                    label_indices=label_idx)
