"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled for Hopper
(``sm_90a``) into ``_build/lib<name>-<hash>.so`` the first time it is used,
from the sources in this checkout only. The hash covers the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited kernel is rebuilt
and a stale library is never loaded.
Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default place."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` anew. Returns (library, seconds, the
    compiler's output, which holds ptxas' register and spill report)."""
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    (BUILD_DIR / f"{out.stem}.log").write_text(log)
    return out, seconds, log


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The compiled library for ``csrc/<name>.cu``, built on first use."""
    path = library_path(name)
    if not path.exists():
        path, _, _ = build(name)
    return ctypes.CDLL(str(path))
