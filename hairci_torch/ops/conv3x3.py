"""3x3 convolution (stride 1, padding 1) with optional per-channel
statistics: a CUDA kernel and its plain twin.

Kernel: ``csrc/conv3x3.cu``, written by hand for Hopper (``sm_90a``), built
with nvcc at first use and bound with ctypes. It replaces the TPU kernel
``tools/fused_conv_bn_bench.py:pallas_conv3x3`` (``_conv_kernel``): nine
shifted (H*W, Cin) x (Cin, Cout) products accumulated in f32, plus a bias,
rounded to the input's type; with ``stats`` also the per-channel sum and sum
of squares of the f32 accumulator over all B*H*W positions.

What bounds it on the card: at the TPU tool's shape, (256, 56, 56, 64) -> 64
in bf16, the 205.6 MB it must move and the 59.2 GFLOP it does take the card
about the same time (0.061 ms each, at 3.35 TB/s and 989 TFLOP/s). The kernel
does its products as f32 FMAs on widened values, in shared-memory tiles with
a zero-filled halo (no padded copy of x), so its own ceiling is the f32 FMA
rate; tensor cores are later work.

The port's tensors are read as they are: activations are ``channels_last``
NCHW (NHWC in memory), weights are torch's (Cout, Cin, 3, 3) parameters.
Weights and bias are rounded to the input's type first, as the model's conv
does (``models/resnet.py:Conv2d``), and handed to the kernel as f32 in
(tap, Cin, Cout) order. There is no backward: the JAX package has none for
this kernel either, so the wrapper refuses inputs that need a gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

ConvResult = Union[torch.Tensor,
                   Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None,
                      stats: bool = False) -> ConvResult:
    """Plain twin: ``F.conv2d`` in full f32 (TF32 off) on the values rounded
    to ``x``'s type, + bias; the sums of that f32 result; then the cast to
    ``x``'s type, ``channels_last``. Returns y, or (y, sum, sumsq)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x.float(), w.to(x.dtype).float(),
                     None if b is None else b.to(x.dtype).float(), padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    out = y.to(x.dtype).contiguous(memory_format=torch.channels_last)
    if not stats:
        return out
    return out, y.sum(dim=(0, 2, 3)), (y * y).sum(dim=(0, 2, 3))


@functools.lru_cache(maxsize=None)
def _library() -> Tuple[ctypes.CDLL, int, int]:
    """(library, tile rows, tile columns of one block's output pixels)."""
    from hairci_torch.ops._build import load_library

    lib = load_library("conv3x3")
    lib.hairci_conv3x3.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                                   + [ctypes.c_void_p] * 3
                                   + [ctypes.c_int] * 5
                                   + [ctypes.c_void_p] * 5)
    lib.hairci_conv3x3.restype = ctypes.c_int
    lib.hairci_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hairci_cuda_error_string.restype = ctypes.c_char_p
    lib.hairci_conv3x3_tile.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.hairci_conv3x3_tile.restype = None
    rows, cols = ctypes.c_int(), ctypes.c_int()
    lib.hairci_conv3x3_tile(ctypes.byref(rows), ctypes.byref(cols))
    return lib, rows.value, cols.value


def kernel_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the kernel's (9, Cin, Cout) f32, tap-major
    (dy * 3 + dx), holding the values rounded to ``dtype``."""
    cout, cin = w.shape[:2]
    return (w.detach().to(dtype).float().permute(2, 3, 1, 0)
            .reshape(9, cin, cout).contiguous())


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None,
            stats: bool = False) -> ConvResult:
    """3x3 convolution, stride 1, zero padding 1, of a ``channels_last``
    (B, Cin, H, W) f32 or bf16 tensor with (Cout, Cin, 3, 3) weights and an
    optional (Cout,) bias, accumulated in f32. Returns y (B, Cout, H, W),
    ``channels_last``, in ``x``'s type; with ``stats`` also the f32 (Cout,)
    sum and sum of squares of the accumulator over B*H*W. Cin and Cout must
    be multiples of 8. CUDA tensors launch the kernel; CPU tensors take the
    twin. No gradient flows through it."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv3x3: need (B, Cin, H, W) and (Cout, Cin, 3, 3)"
                         f", got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv3x3: dtype {x.dtype}; need float32/bfloat16")
    B, cin, H, W = x.shape
    cout = w.shape[0]
    if tuple(w.shape[1:]) != (cin, 3, 3):
        raise ValueError(f"conv3x3: weights {tuple(w.shape)} do not match "
                         f"{cin} input channels of a 3x3 kernel")
    if cin % 8 or cout % 8:
        raise ValueError(f"conv3x3: Cin {cin} and Cout {cout} must be "
                         "multiples of 8")
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f"conv3x3: bias {tuple(b.shape)} is not ({cout},)")
    for name, t in (("weights", w), ("bias", b)):
        if t is not None and t.device != x.device:
            raise ValueError(f"conv3x3: {name} on {t.device}, input on "
                             f"{x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        raise RuntimeError("conv3x3 has no backward: call it under "
                           "torch.no_grad()")
    nhwc = x.permute(0, 2, 3, 1)
    if not nhwc.is_contiguous():
        raise ValueError("conv3x3: input must be channels_last (NHWC in "
                         f"memory); got strides {x.stride()}")
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, b, stats)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: no kernel for {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("conv3x3: input must be 16-byte aligned")
    out = torch.empty((B, H, W, cout), dtype=x.dtype, device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    if B == 0 or H == 0 or W == 0:
        zeros = (torch.zeros(cout, **f32), torch.zeros(cout, **f32))
        y = out.permute(0, 3, 1, 2)
        return (y, *zeros) if stats else y
    wk = kernel_weights(w, x.dtype)
    bk = None if b is None else b.detach().to(x.dtype).float().contiguous()
    lib, tile_rows, tile_cols = _library()
    part_s = part_q = out_s = out_q = None
    if stats:
        tiles = B * -(-H // tile_rows) * -(-W // tile_cols)
        part_s, part_q = torch.empty((2, tiles, cout), **f32)
        out_s, out_q = torch.empty((2, cout), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        err = lib.hairci_conv3x3(
            x.data_ptr(), int(x.dtype == torch.bfloat16), wk.data_ptr(),
            ptr(bk), out.data_ptr(), B, H, W, cin, cout, ptr(part_s),
            ptr(part_q), ptr(out_s), ptr(out_q),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("conv3x3 kernel launch failed: "
                           + lib.hairci_cuda_error_string(err).decode())
    conv3x3.launches += 1
    y = out.permute(0, 3, 1, 2)
    return (y, out_s, out_q) if stats else y


conv3x3.launches = 0
