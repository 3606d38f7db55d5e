"""Fused gallery scoring + streaming top-k: a CUDA kernel and its plain twin.

Kernel: ``csrc/topk.cu``, written by hand for Hopper (``sm_90a``), built with
nvcc at first use and bound with ctypes. It replaces the TPU kernel
``hairci/ops/topk_pallas.py:_topk_kernel`` (with ``_select_topk``).

What bounds it on the card: one read of the gallery, N * D * bytes (N rows of
width D in f32 or bf16) -- 320 MB for a 103,945 x 768 f32 gallery -- while
the plain version writes and sorts the whole (Q, N) score matrix. The kernel
streams each row once per query tile with 16-byte coalesced loads, scores it
against the tile held in shared memory with f32 FMAs, and keeps the per-query
top-k in registers; a second pass merges the per-split lists. Enough gallery
splits are launched to fill every SM even at Q = 1. bf16 storage halves the
bytes read; scores still accumulate in f32.

Semantics match ``GalleryIndex.search``: inner-product scores, descending,
ties to the lower gallery index, rows >= ``n_valid`` ignored. Indices are
int64 where the JAX package returns int32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

MAX_K = 16
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
_SPLIT_MIN_ROWS = 64


def topk_gallery_search_reference(q: torch.Tensor, g: torch.Tensor, k: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: f32 ``q @ g.T`` (callers keep TF32 off), then a stable
    descending sort cut to k -- ``torch.topk`` gives no order among ties."""
    scores = torch.matmul(q.float(), g.float().T)
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].contiguous()


def plan(Q: int, N: int, D: int, k: int, sm_count: int):
    """(log2 queries per block, list length, gallery splits) for a launch."""
    kcap = 8 if k <= 8 else 16
    log_qt = 0 if Q == 1 else 3 if Q <= 8 else 5
    while log_qt and (1 << log_qt) * D * 4 > _SMEM_LIMIT:
        log_qt = {5: 3, 3: 0}[log_qt]
    if D * 4 > _SMEM_LIMIT:
        raise ValueError(f"topk_gallery_search: width {D} does not fit in "
                         "shared memory")
    q_tiles = -(-Q // (1 << log_qt))
    splits = max(1, min(math.ceil(4 * sm_count / q_tiles),
                        math.ceil(N / _SPLIT_MIN_ROWS)))
    return log_qt, kcap, splits


def _library() -> ctypes.CDLL:
    from hairci_torch.ops._build import load_library

    lib = load_library("topk")
    fn = lib.hairci_topk_gallery_search
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        lib.hairci_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hairci_cuda_error_string.restype = ctypes.c_char_p
    return lib


def topk_gallery_search(q: torch.Tensor, g: torch.Tensor, k: int = 5,
                        n_valid: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (Q, k) f32, indices (Q, k) int64) of the best gallery rows.

    ``q`` (Q, D) f32 and ``g`` (N, D) f32 or bf16, both contiguous and on one
    device; only rows ``< n_valid`` are searched. CUDA tensors launch the
    kernel; CPU tensors take the plain twin. k is cut to the row count and
    must then be at most 16, as on the TPU.
    """
    if q.dim() != 2 or g.dim() != 2 or q.shape[1] != g.shape[1]:
        raise ValueError(f"topk_gallery_search: shapes {tuple(q.shape)} and "
                         f"{tuple(g.shape)} are not (Q, D) and (N, D)")
    if q.dtype != torch.float32 or g.dtype not in (torch.float32,
                                                   torch.bfloat16):
        raise ValueError(f"topk_gallery_search: dtypes {q.dtype}, {g.dtype}; "
                         "need float32 queries, float32/bfloat16 gallery")
    if not (q.is_contiguous() and g.is_contiguous()):
        raise ValueError("topk_gallery_search: inputs must be contiguous")
    if q.device != g.device:
        raise ValueError(f"topk_gallery_search: devices {q.device} and "
                         f"{g.device} differ")
    n = g.shape[0] if n_valid is None else int(n_valid)
    if not 0 <= n <= g.shape[0]:
        raise ValueError(f"topk_gallery_search: n_valid={n} outside "
                         f"[0, {g.shape[0]}]")
    k = min(int(k), n)
    if k > MAX_K:
        raise ValueError(f"topk_gallery_search supports k <= {MAX_K} "
                         f"(got k={k}); use GalleryIndex.search for larger k")
    Q, D = q.shape
    if k < 1 or Q == 0:
        return (torch.empty((Q, max(k, 0)), dtype=torch.float32,
                            device=q.device),
                torch.empty((Q, max(k, 0)), dtype=torch.int64,
                            device=q.device))
    if q.device.type == "cpu":
        return topk_gallery_search_reference(q, g[:n], k)
    if q.device.type != "cuda":
        raise ValueError(f"topk_gallery_search: no kernel for {q.device}")

    lib = _library()
    sm_count = torch.cuda.get_device_properties(q.device).multi_processor_count
    log_qt, kcap, splits = plan(Q, n, D, k, sm_count)
    vec = 8 if g.dtype == torch.bfloat16 else 4
    aligned = (D % vec == 0 and q.data_ptr() % 16 == 0
               and g.data_ptr() % 16 == 0)
    part_s = torch.empty((Q, splits, kcap), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty((Q, splits, kcap), dtype=torch.int32,
                         device=q.device)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((Q, k), dtype=torch.int64, device=q.device)
    # the launch goes to the calling thread's current device
    with torch.cuda.device(q.device):
        err = lib.hairci_topk_gallery_search(
            q.data_ptr(), g.data_ptr(), int(g.dtype == torch.bfloat16), Q, n,
            D, k, log_qt, kcap, splits, D // vec if aligned else 0,
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("topk_gallery_search kernel launch failed: "
                           + lib.hairci_cuda_error_string(err).decode())
    topk_gallery_search.launches += 1
    return out_s, out_i


topk_gallery_search.launches = 0
