"""FAISS flat-index file compatibility, no faiss needed (port of
``hairci/retrieval/faiss_io.py``; the files are byte for byte the JAX
package's).

The reference persists its demo gallery as a FAISS ``IndexFlatL2`` file plus
a pickled path list (``faiss.write_index`` at
the reference's ``HairPretraining/app/inference.py:96-98``); DualViewHair's
quantitative eval builds the same kind of index
(``quantitative_eval.py:121``). Users migrating from the reference have
those artifacts on disk — this module reads and writes the FAISS binary
format for flat indexes directly so they load into a
:class:`~hairci_torch.retrieval.index.GalleryIndex` on the caller's device
(and can be exported back for faiss-based tooling).

Format (FAISS ``impl/index_write.cpp`` for ``IndexFlat``):

- fourcc, 4 bytes: ``IxF2`` (METRIC_L2), ``IxFI`` (METRIC_INNER_PRODUCT),
  or the generic ``IxFl`` (metric taken from the header field)
- header: ``d`` int32 · ``ntotal`` int64 · two dummy int64 (historical
  size fields, written as ``1 << 20``) · ``is_trained`` bool (1 byte) ·
  ``metric_type`` int32 (0 = IP, 1 = L2; ``metric_arg`` float follows only
  for metric_type > 1)
- vectors via ``WRITEXBVECTOR``: uint64 element count (= ntotal * d
  float32 elements) followed by the raw little-endian float32 data.
  faiss always writes the float count (its writer emits
  ``codes.size() / 4`` for back-compat even though flat codes are stored
  as bytes internally); the reader here additionally tolerates a
  byte-count (``ntotal * d * 4``) header as defensive leniency — no faiss
  version produces it.

Everything is little-endian, matching FAISS's raw-struct I/O.

Note on metrics: the reference L2-normalizes features before ``add`` and
``search``, so IndexFlatL2 ascending-distance order equals descending
cosine order — exactly :class:`GalleryIndex`'s ranking. Import therefore
preserves retrieval ranking for reference-built indexes.
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import List, Tuple

import numpy as np

from hairci_torch.retrieval.index import GalleryIndex
from hairci_torch.utils.device import DeviceLike

METRIC_INNER_PRODUCT = 0
METRIC_L2 = 1

_FOURCC = {METRIC_L2: b"IxF2", METRIC_INNER_PRODUCT: b"IxFI"}
_HEADER = struct.Struct("<iqqq?i")  # d, ntotal, dummy, dummy, trained, metric


def write_flat_index(vectors: np.ndarray, path: str,
                     metric: int = METRIC_L2) -> None:
    """Write ``vectors`` (n, d) float32 as a FAISS IndexFlat file."""
    v = np.ascontiguousarray(vectors, dtype="<f4")
    if v.ndim != 2:
        raise ValueError(f"vectors must be (n, d), got {v.shape}")
    n, d = v.shape
    with open(path, "wb") as f:
        f.write(_FOURCC[metric])
        f.write(_HEADER.pack(d, n, 1 << 20, 1 << 20, True, metric))
        f.write(struct.pack("<Q", n * d))
        f.write(v.tobytes())


def read_flat_index(path: str) -> Tuple[np.ndarray, int]:
    """Read a FAISS IndexFlat file → (vectors (n, d) float32, metric)."""
    with open(path, "rb") as f:
        data = f.read()
    fourcc, off = data[:4], 4
    if fourcc not in (b"IxF2", b"IxFI", b"IxFl"):
        raise ValueError(
            f"{path}: not a FAISS flat index (fourcc {fourcc!r}); only "
            "IndexFlatL2/IndexFlatIP files are supported without faiss")
    d, ntotal, _, _, _, metric = _HEADER.unpack_from(data, off)
    off += _HEADER.size
    if metric > METRIC_L2:  # metric_arg float present for extended metrics
        off += 4
    (count,), off = struct.unpack_from("<Q", data, off), off + 8
    n_bytes = ntotal * d * 4
    if len(data) - off < n_bytes or count not in (ntotal * d, n_bytes):
        raise ValueError(
            f"{path}: vector payload mismatch (d={d}, ntotal={ntotal}, "
            f"count={count}, {len(data) - off} bytes remain)")
    vecs = np.frombuffer(data, dtype="<f4", count=ntotal * d, offset=off)
    return vecs.reshape(ntotal, d).copy(), metric


def load_faiss_flat(index_path: str, paths_path: str | None = None,
                    device: DeviceLike = None) -> GalleryIndex:
    """Reference-artifact loader: FAISS flat index (+ pickled path list) →
    :class:`GalleryIndex` on ``device`` (default cuda). ``paths_path``
    defaults to the pickle next to the index following the reference's
    naming (``index_*.index`` ↔ ``paths_*.pkl``, app/inference.py:96-98).
    The pickle is unpickled in full: load only files you trust."""
    vectors, _ = read_flat_index(index_path)
    # GalleryIndex ranks by cosine. For UNIT-NORM rows that equals both
    # IndexFlatL2's ascending-distance and IndexFlatIP's descending-score
    # order (the reference always normalizes before add, inference.py:90);
    # for unnormalized rows neither metric agrees with cosine, so importing
    # would silently change the ranking faiss produced — refuse instead.
    norms = np.linalg.norm(vectors, axis=1)
    if len(norms) and float(np.abs(norms - 1.0).max()) > 1e-3:
        raise ValueError(
            f"{index_path}: rows are not L2-normalized (|v| in "
            f"[{norms.min():.4f}, {norms.max():.4f}]); cosine ranking would "
            "differ from what faiss returned for this index. Normalize the "
            "gallery before export, or build a GalleryIndex from the raw "
            "vectors via read_flat_index() if cosine semantics are intended.")
    if paths_path is None:
        base = os.path.basename(index_path)
        # only a LEADING "index_" prefix maps to "paths_" (the reference's
        # naming, app/inference.py:96-98) — a blanket replace would rewrite
        # interior occurrences in names like "my_index_region.index"
        stem = ("paths_" + base[len("index_"):]
                if base.startswith("index_") else base)
        cand = os.path.join(os.path.dirname(index_path),
                            stem.rsplit(".", 1)[0] + ".pkl")
        paths_path = cand if os.path.exists(cand) else None
    if paths_path is not None:
        with open(paths_path, "rb") as f:
            paths: List[str] = [str(p) for p in pickle.load(f)]
        if len(paths) != len(vectors):
            raise ValueError(
                f"{paths_path}: {len(paths)} paths for {len(vectors)} vectors")
    else:
        paths = [str(i) for i in range(len(vectors))]
    return GalleryIndex(vectors, paths, device=device)


def save_faiss_flat(index: GalleryIndex, index_path: str,
                    paths_path: str | None = None,
                    metric: int = METRIC_L2) -> None:
    """Export a :class:`GalleryIndex` as FAISS index + path pickle, the
    artifact pair the reference's demo persists."""
    # storage may be bf16 and on the card
    emb = index.embeddings.float().cpu().numpy()
    write_flat_index(emb, index_path, metric)
    if paths_path is not None:
        with open(paths_path, "wb") as f:
            pickle.dump(list(index.paths), f)
