"""Per-channel BatchNorm statistics: a CUDA kernel and its plain twin.

Kernel: ``csrc/bn_stats.cu``, written by hand for Hopper (``sm_90a``), built
with nvcc at first use and bound with ctypes. It replaces the TPU kernel
``tools/bn_stats_bench.py:pallas_stats`` (``_stats_kernel``): the f32 sum and
sum of squares over the rows of an (M, C) channel-last view in one read.

What bounds it on the card: the one read of the input, M * C * bytes, since
it does 3 FLOPs per element. Each lane reads 16 (f32) or 4 (bf16) bytes of a
row, neighbouring lanes on neighbouring channels; row splits fill the card
and a second small kernel adds them in order, so no atomics are used and the
result is the same from run to run. The plain twin promotes the whole tensor
to f32 first, which is one more write and read of it at twice the width.

``BNStats`` gives the sums a gradient: d/dx = g_sum + 2 x g_sumsq, in plain
torch. The JAX package has no backward kernel here either: XLA differentiates
the plain formula of ``hairci/models/norm.py``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

_TARGET_BLOCKS_PER_SM = 4
_MIN_ROWS_PER_SPLIT = 64
_MAX_SPLITS = 65535


def bn_stats_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: (sum, sum of squares) over axis 0, in f32."""
    xf = x.float()
    return xf.sum(0), (xf * xf).sum(0)


def plan(M: int, C: int, vec: int, sm_count: int) -> Tuple[int, int]:
    """(row splits, rows per split) for a launch."""
    tiles = -(-C // (32 * vec))
    splits = max(1, min(math.ceil(_TARGET_BLOCKS_PER_SM * sm_count / tiles),
                        math.ceil(M / _MIN_ROWS_PER_SPLIT), _MAX_SPLITS))
    rows = -(-M // splits)
    return -(-M // rows), rows


@functools.lru_cache(maxsize=None)
def _sm_count(index: Optional[int]) -> int:
    """SMs of a card; 55 launches a step make the property query show."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library() -> ctypes.CDLL:
    from hairci_torch.ops._build import load_library

    lib = load_library("bn_stats")
    fn = lib.hairci_bn_stats
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong] + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        lib.hairci_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hairci_cuda_error_string.restype = ctypes.c_char_p
    return lib


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
    # the combine kernel writes every channel
    out_s = torch.empty(C, dtype=torch.float32, device=x.device)
    out_q = torch.empty(C, dtype=torch.float32, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    vec = 2 if bf16 else 4
    if C % vec or x.data_ptr() % (2 * vec if bf16 else 4 * vec):
        vec = 1
    lib = _library()
    splits, rows = plan(M, C, vec, _sm_count(x.device.index))
    part_s = torch.empty((splits, C), dtype=torch.float32, device=x.device)
    part_q = torch.empty((splits, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.hairci_bn_stats(
            x.data_ptr(), int(bf16), M, C, vec, splits, rows,
            part_s.data_ptr(), part_q.data_ptr(), out_s.data_ptr(),
            out_q.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("bn_stats kernel launch failed: "
                           + lib.hairci_cuda_error_string(err).decode())
    bn_stats.launches += 1
    return out_s, out_q


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
