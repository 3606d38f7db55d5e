"""ctypes binding of the C++ batch image decoder (``imageio.cpp``, the
port's copy of ``hairci/native/imageio.cpp``).

``decode_batch(paths, size, mode)`` decodes a whole batch on a thread pool
inside the library (libjpeg and libpng, no GIL) into one uint8 NHWC array
and an ok-mask. The library is built with g++ on first use, from the source
in this checkout, into ``_build/libimageio-<hash>.so``; the hash covers the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded. Building needs the libjpeg and libpng headers and libraries.
Nothing is built when this module is imported.

``decode_batch.decodes`` counts the images handed to the library, so a
caller can tell which route a loader took.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from hairci_torch.native import _gxx

log = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "imageio.cpp"
BUILD_DIR = _gxx.BUILD_DIR
LIBS = ("-ljpeg", "-lpng")

MODE_RAW_RESIZE = 0
MODE_CENTER_CROP = 1


def library_path() -> Path:
    return _gxx.library_path(SRC, "libimageio", LIBS)


def build() -> Path:
    """Compile ``imageio.cpp`` anew; raises RuntimeError with the compiler's
    message when it fails."""
    return _gxx.build(SRC, "libimageio", LIBS)


@functools.lru_cache(maxsize=None)
def _load() -> Tuple[Optional[ctypes.CDLL], str]:
    """(the library, "") or (None, why it is unavailable); built and loaded
    once a process."""
    try:
        path = library_path()
        lib = ctypes.CDLL(str(path if path.exists() else build()))
    except (OSError, RuntimeError) as e:
        log.warning("native imageio unavailable: %s", e)
        return None, str(e)
    lib.hairci_decode_batch.restype = ctypes.c_int64
    lib.hairci_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib, ""


def available() -> bool:
    return _load()[0] is not None


def unavailable_reason() -> str:
    """Why the library cannot be built or loaded ("" when it can)."""
    return _load()[1]


def decode_batch(paths: Sequence[str], size: int, mode: int,
                 n_threads: int = 0
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode ``paths`` -> ((N, size, size, 3) uint8, (N,) bool ok-mask).

    Returns None when the library cannot be built or loaded (the caller
    decides whether to fall back to PIL)."""
    if mode not in (MODE_RAW_RESIZE, MODE_CENTER_CROP):
        raise ValueError(f"unknown native decode mode {mode!r}")
    if size < 1:
        raise ValueError(f"size must be positive, got {size}")
    lib = _load()[0]
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    if n_threads <= 0:
        n_threads = min(max(os.cpu_count() or 4, 1), 16)
    lib.hairci_decode_batch(
        c_paths, n, size, mode, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    decode_batch.decodes += n
    return out, ok.astype(bool)


decode_batch.decodes = 0
