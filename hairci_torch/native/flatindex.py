"""ctypes binding of the host flat index (``flatindex.cpp``, the port's copy
of ``hairci/native/flatindex.cpp``): ``NativeFlatIndex`` has the FAISS flat
index's surface the reference uses (``add``, ``search``, and ``save`` /
``load`` for ``write_index`` / ``read_index``). Its files are the JAX
package's byte for byte, so each package reads the other's.

The library is built with g++ on first use, from the source in this
checkout, into ``_build/libflatindex-<hash>.so``; the hash covers the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded. A failed build raises. Nothing is built when this module is
imported.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from hairci_torch.native import _gxx

SRC = Path(__file__).resolve().parent / "flatindex.cpp"

METRIC_IP = 0
METRIC_L2 = 1


def library_path() -> Path:
    return _gxx.library_path(SRC, "libflatindex")


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The library, built and loaded once a process."""
    path = library_path()
    lib = ctypes.CDLL(str(path if path.exists()
                          else _gxx.build(SRC, "libflatindex")))
    lib.flat_index_new.restype = ctypes.c_void_p
    lib.flat_index_new.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.flat_index_free.restype = None
    lib.flat_index_free.argtypes = [ctypes.c_void_p]
    lib.flat_index_size.restype = ctypes.c_int64
    lib.flat_index_size.argtypes = [ctypes.c_void_p]
    lib.flat_index_add.restype = None
    lib.flat_index_add.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.flat_index_search.restype = None
    lib.flat_index_search.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.flat_index_save.restype = ctypes.c_int
    lib.flat_index_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.flat_index_load.restype = ctypes.c_void_p
    lib.flat_index_load.argtypes = [ctypes.c_char_p]
    return lib


class NativeFlatIndex:
    """FAISS IndexFlat{IP,L2} equivalent on the host CPU: exact scores
    (inner product, or the negative squared L2 distance), descending, ties
    to the lower row."""

    def __init__(self, dim: int, metric: int = METRIC_IP,
                 _handle: Optional[int] = None):
        self._lib = _load()
        self.dim = dim
        self.metric = metric
        self._handle = (_handle if _handle is not None
                        else self._lib.flat_index_new(dim, metric))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.flat_index_free(self._handle)
            self._handle = None

    def __len__(self) -> int:
        return int(self._lib.flat_index_size(self._handle))

    def add(self, vecs: np.ndarray) -> None:
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(f"vectors must be (n, {self.dim}), got "
                             f"{vecs.shape}")
        self._lib.flat_index_add(
            self._handle, vecs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            vecs.shape[0])

    def search(self, queries: np.ndarray, k: int,
               num_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (Q, k) f32, indices (Q, k) int64); ``num_threads`` 0 uses
        every core."""
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        if queries.ndim != 2 or queries.shape[1] != self.dim:
            raise ValueError(f"queries must be (Q, {self.dim}), got "
                             f"{queries.shape}")
        nq = queries.shape[0]
        k = min(k, len(self))
        scores = np.empty((nq, k), np.float32)
        indices = np.empty((nq, k), np.int64)
        self._lib.flat_index_search(
            self._handle,
            queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nq, k,
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            num_threads)
        return scores, indices

    def save(self, path: str) -> None:
        if self._lib.flat_index_save(self._handle, os.fsencode(path)) != 0:
            raise IOError(f"failed to save index to {path}")

    @classmethod
    def load(cls, path: str) -> "NativeFlatIndex":
        lib = _load()
        handle = lib.flat_index_load(os.fsencode(path))
        if not handle:
            raise IOError(f"failed to load index from {path}")
        # dim and metric are bytes 8-24 of the file, after the magic
        with open(path, "rb") as f:
            f.seek(8)
            dim, metric = struct.unpack("<qq", f.read(16))
        return cls(int(dim), int(metric), _handle=handle)
