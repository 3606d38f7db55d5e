"""Per-channel BatchNorm statistics: a CUDA kernel and its plain twin.

Kernel: ``csrc/bn_stats.cu``, written by hand for Hopper (``sm_90a``), built
with nvcc at first use and bound with ctypes. It replaces the TPU kernel
``tools/bn_stats_bench.py:pallas_stats`` (``_stats_kernel``): the f32 sum and
sum of squares over the rows of an (M, C) channel-last view in one read.

What bounds it on the card: the one read of the input, M * C * bytes, since
it does 3 FLOPs per element; and, at the shapes of a training step (a
ResNet-50 SHAM step calls it 55 times on 0.4 to 308 MB), the memory's latency
and the host's time to launch it. So the kernel is one launch: every lane
loads 16 bytes (8 bf16 or 4 f32 channels) of four rows before it adds any,
``plan`` shapes the block by C so that a warp reads whole lines and the card
holds about four blocks an SM, and the block that finishes last adds the
row splits' partials in index order (no atomics on the data: the same bits on
every run). Small inputs get one stage and no partials at all. The wrapper
does one ``torch.empty`` per call and keeps the library's function, the
card's SM count and a zeroed ticket array per stream. The plain twin promotes
the whole tensor to f32 first, one more write and read of it at twice the
width.

``BNStats`` gives the sums a gradient: d/dx = g_sum + 2 x g_sumsq, in plain
torch. The JAX package has no backward kernel here either: XLA differentiates
the plain formula of ``hairci/models/norm.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Tuple

import torch

# The block of csrc/bn_stats.cu (``_library`` holds the two together): threads,
# and independent 16-byte loads per thread and loop turn.
THREADS = 256
UNROLL = 4
# channel groups per block: 8 x 16 bytes are one 128-byte line of a row.
# Narrow tiles make many channel tiles of few splits each, and what the last
# block of a tile has to add grows with splits x tile width (measured: 32
# groups cost the step's 55 inputs 2.21 ms, 16 cost 1.90, 8 cost 1.70).
# Without 16-byte loads a warp takes 32 neighbouring channels of one row.
_TILE_GROUPS = 8
_TILE_GROUPS_SCALAR = 32
_TARGET_BLOCKS_PER_SM = 4    # measured: 2 -> 1.80 ms, 3 -> 1.71, 6 -> 1.98
_MIN_TURNS_PER_SPLIT = 2     # loop turns a block should at least make
_MAX_SPLITS = 65535
# up to this many values (1 MB of bf16) one stage does it: the channel tiles
# are the blocks, no partials, no ticket
_SINGLE_STAGE_VALUES = 1 << 19
_MIN_COUNTERS = 4096


def bn_stats_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: (sum, sum of squares) over axis 0, in f32."""
    xf = x.float()
    return xf.sum(0), (xf * xf).sum(0)


def vector_width(C: int, itemsize: int, address: int) -> int:
    """Channels a lane loads at once: 16 bytes' worth (8 bf16, 4 f32) when
    every row then starts on a 16-byte boundary, else 1."""
    vec = 16 // itemsize
    return vec if C % vec == 0 and address % 16 == 0 else 1


def plan(M: int, C: int, vec: int, sm_count: int) -> Tuple[int, int, int]:
    """(log2 of the channel groups per block, row splits, rows per split)
    for a launch on (M, C) with ``vec`` channels per lane. A block is
    (THREADS / groups row lanes) x (groups channel groups); the grid is
    (channel tiles, row splits). Split i takes rows [i * rows, (i + 1) *
    rows), cut at M; every split is non-empty."""
    groups = -(-C // vec)
    cap = _TILE_GROUPS if vec > 1 else _TILE_GROUPS_SCALAR
    log_tg = 0
    while (1 << log_tg) < min(groups, cap):
        log_tg += 1
    if M * C <= _SINGLE_STAGE_VALUES:
        return log_tg, 1, M
    tiles = -(-groups // (1 << log_tg))
    rows_per_turn = UNROLL * (THREADS >> log_tg)
    splits = max(1, min(_TARGET_BLOCKS_PER_SM * sm_count // tiles,
                        M // (_MIN_TURNS_PER_SPLIT * rows_per_turn),
                        _MAX_SPLITS))
    rows = -(-M // splits)
    return log_tg, -(-M // rows), rows


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """SMs of a card; 55 launches a step make the property query show."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> Tuple[Callable, Callable]:
    """(the launch function, the error-string function) of the built
    library, with their argument types set once."""
    from hairci_torch.ops._build import load_library

    lib = load_library("bn_stats")
    fn = lib.hairci_bn_stats
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    lib.hairci_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hairci_cuda_error_string.restype = ctypes.c_char_p
    lib.hairci_bn_stats_block.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.hairci_bn_stats_block.restype = None
    threads, unroll = ctypes.c_int(), ctypes.c_int()
    lib.hairci_bn_stats_block(ctypes.byref(threads), ctypes.byref(unroll))
    if (threads.value, unroll.value) != (THREADS, UNROLL):
        raise RuntimeError(
            f"bn_stats: the kernel's block ({threads.value} threads, unroll "
            f"{unroll.value}) is not the plan's ({THREADS}, {UNROLL})")
    return fn, lib.hairci_cuda_error_string


# (device index, stream) -> the zeroed tickets of that stream's launches:
# one per channel tile; the kernel leaves them zeroed
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _tickets(index: int, stream: int, tiles: int) -> torch.Tensor:
    buf = _counters.get((index, stream))
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, _MIN_COUNTERS), dtype=torch.int32,
                          device=torch.device("cuda", index))
        _counters[(index, stream)] = buf
    return buf


def bn_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum (C,), sum of squares (C,)) in f32 of a contiguous (M, C) f32 or
    bf16 tensor. CUDA tensors launch the kernel; CPU tensors take the twin."""
    if x.dim() != 2:
        raise ValueError(f"bn_stats: shape {tuple(x.shape)} is not (M, C)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bn_stats: dtype {x.dtype}; need float32/bfloat16")
    if not x.is_contiguous():
        raise ValueError("bn_stats: input must be contiguous")
    if x.device.type == "cpu":
        return bn_stats_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"bn_stats: no kernel for {x.device}")
    M, C = x.shape
    if M == 0 or C == 0:
        return (torch.zeros(C, dtype=torch.float32, device=x.device),
                torch.zeros(C, dtype=torch.float32, device=x.device))
    index = x.device.index
    address = x.data_ptr()
    vec = vector_width(C, x.element_size(), address)
    log_tg, splits, rows = plan(M, C, vec, _sm_count(index))
    # one allocation: the (2, C) result, then the (splits, 2, C) partials on
    # a 16-byte boundary; the kernel writes every value it reads
    head = -(-2 * C // 4) * 4
    buf = torch.empty(head + (2 * C * splits if splits > 1 else 0),
                      dtype=torch.float32, device=x.device)
    out = buf.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tiles = -(-C // (vec << log_tg))
    launch, error_string = _library()
    args = (address, int(x.dtype == torch.bfloat16), M, C, vec, log_tg,
            splits, rows, out + 4 * head, out,
            _tickets(index, stream, tiles).data_ptr(), stream)
    if index == torch.cuda.current_device():
        err = launch(*args)
    else:
        with torch.cuda.device(index):
            err = launch(*args)
    if err != 0:
        raise RuntimeError("bn_stats kernel launch failed: "
                           + error_string(err).decode())
    bn_stats.launches += 1
    return buf[:C], buf[C:2 * C]


bn_stats.launches = 0


class BNStats(torch.autograd.Function):
    """``bn_stats`` with a gradient with respect to its input."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return bn_stats(x)

    @staticmethod
    def backward(ctx, g_sum, g_sq):
        (x,) = ctx.saved_tensors
        return (g_sum + 2.0 * x.float() * g_sq).to(x.dtype)
