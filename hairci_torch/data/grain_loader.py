"""Grain input pipeline (the port's copy of ``hairci/data/grain_loader.py``).

Beside the threaded ``DataLoader`` it offers multiprocess decode workers,
deterministic global shuffling through grain's ``IndexSampler``, multi-host
sharding and a checkpointable iterator. It yields the same (images (B, S, S,
3) uint8, labels (B,) int32) batches, so the Trainer takes either. grain is
imported when a ``GrainLoader`` is made, never with this module: a machine
without grain can import the port.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from hairci_torch.data.loader import decode_image
from hairci_torch.data.manifest import Manifest


class _ManifestSource:
    """grain RandomAccessDataSource over a Manifest; an image that fails to
    decode becomes zeros."""

    def __init__(self, manifest: Manifest, size: int, mode: str):
        self.manifest = manifest
        self.size = size
        self.mode = mode

    def __len__(self) -> int:
        return len(self.manifest)

    def __getitem__(self, idx: int):
        arr = decode_image(self.manifest.paths[idx], self.mode, self.size)
        if arr is None:
            arr = np.zeros((self.size, self.size, 3), np.uint8)
        return {"image": arr,
                "label": np.int32(self.manifest.label_indices[idx])}


class GrainLoader:
    """Deterministic, multiprocess, multi-host-sharded batch loader."""

    def __init__(
        self,
        manifest: Manifest,
        batch_size: int,
        size: int = 224,
        mode: str = "raw_resize",
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 42,
        num_workers: int = 8,
        num_epochs: Optional[int] = None,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        import grain.python as gp

        self.batch_size = batch_size
        self.size = size
        self._epoch = 0
        self.manifest = manifest
        self.drop_last = drop_last
        self._gp = gp
        self._source = _ManifestSource(manifest, size, mode)
        self._sampler_kw = dict(
            num_records=len(manifest),
            shard_options=gp.ShardOptions(shard_index=shard_index,
                                          shard_count=shard_count,
                                          drop_remainder=drop_last),
            shuffle=shuffle,
            seed=seed,
        )
        self.num_workers = num_workers
        self.num_epochs = num_epochs

    def __len__(self) -> int:
        n = len(self.manifest)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        gp = self._gp
        sampler = gp.IndexSampler(
            num_epochs=1, **{**self._sampler_kw,
                             "seed": self._sampler_kw["seed"] + self._epoch})
        loader = gp.DataLoader(
            data_source=self._source,
            sampler=sampler,
            operations=[gp.Batch(self.batch_size,
                                 drop_remainder=self.drop_last)],
            worker_count=self.num_workers,
        )
        self._epoch += 1
        for batch in loader:
            yield batch["image"], batch["label"]
