"""g++ builds of the port's native libraries, at first use, from the sources
in this checkout into ``_build/<stem>-<hash>.so``: the hash covers the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded."""

from __future__ import annotations

import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

log = logging.getLogger(__name__)

BUILD_DIR = Path(__file__).resolve().parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread")


def library_path(src: Path, stem: str, libs: Sequence[str] = ()) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        GXX_FLAGS + tuple(libs)).encode()).hexdigest()
    return BUILD_DIR / f"{stem}-{digest[:16]}.so"


def build(src: Path, stem: str, libs: Sequence[str] = ()) -> Path:
    """Compile ``src`` anew; raises RuntimeError with the compiler's message
    when it fails."""
    out = library_path(src, stem, libs)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, str(src), *libs, "-o", tmp]
    log.info("building %s: %s", stem, " ".join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    except OSError as e:    # no g++ at all
        raise RuntimeError(f"g++ could not run: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
