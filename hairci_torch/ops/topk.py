"""Fused gallery scoring + streaming top-k: a CUDA kernel and its plain twin.

Kernel: ``csrc/topk.cu``, written by hand for Hopper (``sm_90a``), built with
nvcc at first use and bound with ctypes. It replaces the TPU kernel
``hairci/ops/topk_pallas.py:_topk_kernel`` (with ``_select_topk``). Two
routes of its first stage, chosen by ``plan``; both end in the same merge
launch:

- ``fma`` (Q below ``BATCHED_MIN_Q``, and inputs the other route does not
  take): bounded by one read of the gallery, N * D * bytes -- 320 MB for a
  103,945 x 768 f32 gallery -- while the plain version writes and sorts the
  whole (Q, N) score matrix. It streams each row once per query tile with
  16-byte coalesced loads, scores it against the tile held in shared memory
  with f32 FMAs, and keeps the per-query top-k in registers. Enough gallery
  splits are launched to fill every SM even at Q = 1.
- ``mma`` (batched queries): a GEMM on the tensor cores (``mma.sync``) with a
  top-k epilogue, 128 queries x 128 gallery rows a tile, in f32 precision by
  split products (3xTF32 for an f32 gallery, q in three bf16 terms for a
  bf16 one). Bounded by those products' operations: 0.248 ms (f32) and
  0.124 ms (bf16) at Q = 256 on an H100's peak rates. D must be a multiple
  of 4 (f32 gallery) or 8 (bf16) and the pointers 16-byte aligned.

bf16 storage halves the bytes read; scores accumulate in f32 on both routes.
``topk_gallery_search.launches`` counts launches, ``.routes`` them by route.

Semantics match ``GalleryIndex.search``: inner-product scores, descending,
ties to the lower gallery index, rows >= ``n_valid`` ignored. Indices are
int64 where the JAX package returns int32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

MAX_K = 16
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
_SPLIT_MIN_ROWS = 64
# Q from which the batched (tensor-core) route is taken. Set from
# ``chip_smoke.py --kernel-times`` at k=5 over 103,945 x 768 on an H100 80GB
# HBM3 at 700 W, the mma route timed on a copy with this constant at 1: at
# Q = 8 fma is faster on both galleries (0.148 vs 0.492 ms f32, 0.290 vs
# 0.325 ms bf16); at 16 mma is 2.5x faster on bf16 (0.343 vs 0.851 ms) and
# within 1 % on f32; at 64 it is faster on both.
BATCHED_MIN_Q = 16
_TC_ROWS = 128      # gallery rows a tile of the batched route
_TC_QUERIES = 128   # queries a block of the batched route


def topk_gallery_search_reference(q: torch.Tensor, g: torch.Tensor, k: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: f32 ``q @ g.T`` (callers keep TF32 off), then a stable
    descending sort cut to k -- ``torch.topk`` gives no order among ties."""
    scores = torch.matmul(q.float(), g.float().T)
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].contiguous()


class Plan(NamedTuple):
    """How one search is launched."""
    route: str             # "fma" or "mma" (tensor cores, batched queries)
    kcap: int              # list length: 8 or 16
    splits: int            # gallery splits
    log_qt: int = 0        # fma: log2 queries a block
    tiles_per_split: int = 0   # mma: 128-row tiles a split


@functools.lru_cache(maxsize=1024)
def plan(Q: int, N: int, D: int, k: int, sm_count: int,
         aligned: bool = True) -> Plan:
    """The route and launch shape of a search. ``aligned``: D a multiple of
    a 16-byte load's elements and both pointers 16-byte aligned, which the
    batched route needs."""
    kcap = 8 if k <= 8 else 16
    if Q >= BATCHED_MIN_Q and aligned:
        # one block an SM; a split is whole tiles. The fewest rounds of
        # tiles (ceil(blocks / SMs) waves of tiles_per_split each), then the
        # fewest blocks: each one stages a pipeline and writes its lists
        n_tiles = -(-N // _TC_ROWS)
        q_tiles = -(-Q // _TC_QUERIES)
        tiles = min(range(1, n_tiles + 1), key=lambda t: (
            -(-q_tiles * -(-n_tiles // t) // sm_count) * t, -t))
        return Plan("mma", kcap, -(-n_tiles // tiles), tiles_per_split=tiles)
    log_qt = 0 if Q == 1 else 3 if Q <= 8 else 5
    while log_qt and (1 << log_qt) * D * 4 > _SMEM_LIMIT:
        log_qt = {5: 3, 3: 0}[log_qt]
    if D * 4 > _SMEM_LIMIT:
        raise ValueError(f"topk_gallery_search: width {D} does not fit in "
                         "shared memory")
    q_tiles = -(-Q // (1 << log_qt))
    splits = max(1, min(math.ceil(4 * sm_count / q_tiles),
                        math.ceil(N / _SPLIT_MIN_ROWS)))
    return Plan("fma", kcap, splits, log_qt=log_qt)


def _library() -> ctypes.CDLL:
    from hairci_torch.ops._build import load_library

    lib = load_library("topk")
    fn = lib.hairci_topk_gallery_search
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        tc = lib.hairci_topk_gallery_search_tc
        tc.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 5)
        tc.restype = ctypes.c_int
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
    must then be at most 16, as on the TPU. ``plan`` chooses the route.
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
    vec = 8 if g.dtype == torch.bfloat16 else 4
    aligned = (D % vec == 0 and q.data_ptr() % 16 == 0
               and g.data_ptr() % 16 == 0)
    p = plan(Q, n, D, k, sm_count, aligned)
    part_s = torch.empty((Q, p.splits, p.kcap), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty((Q, p.splits, p.kcap), dtype=torch.int32,
                         device=q.device)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((Q, k), dtype=torch.int64, device=q.device)
    bf16 = int(g.dtype == torch.bfloat16)
    # the launch goes to the calling thread's current device
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if p.route == "mma":
            err = lib.hairci_topk_gallery_search_tc(
                q.data_ptr(), g.data_ptr(), bf16, Q, n, D, k, p.kcap,
                p.splits, p.tiles_per_split, part_s.data_ptr(),
                part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), stream)
        else:
            err = lib.hairci_topk_gallery_search(
                q.data_ptr(), g.data_ptr(), bf16, Q, n, D, k, p.log_qt,
                p.kcap, p.splits, D // vec if aligned else 0,
                part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
                out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"topk_gallery_search kernel launch failed "
                           f"({p.route} route): "
                           + lib.hairci_cuda_error_string(err).decode())
    topk_gallery_search.launches += 1
    topk_gallery_search.routes[p.route] += 1
    return out_s, out_i


topk_gallery_search.launches = 0
topk_gallery_search.routes = {"fma": 0, "mma": 0}
