"""3x3 convolution (stride 1, padding 1) with optional per-channel
statistics: two CUDA kernels and their plain twin.

Kernels: ``csrc/conv3x3.cu``, written by hand for Hopper (``sm_90a``), built
with nvcc at first use and bound with ctypes. They replace the TPU kernel
``tools/fused_conv_bn_bench.py:pallas_conv3x3`` (``_conv_kernel``): nine
shifted (H*W, Cin) x (Cin, Cout) products accumulated in f32, plus a bias,
rounded to the input's type; with ``stats`` also the per-channel sum and sum
of squares of the f32 accumulator over all B*H*W positions.

Which kernel takes which input (``kernel_route``):
  * ``"mma"``: bf16 with Cin == Cout == 64, any B, H, W: the shape of the
    port's main path (layer1 of the ResNets). What bounds it on the card: at
    (64, 56, 56, 64) the 51.4 MB it must move and the 14.8 GFLOP it does take
    the card about the same time (0.015 ms each, at 3.35 TB/s and 989
    TFLOP/s), so both have to be busy at once. The kernel keeps all nine taps'
    bf16 weights in shared memory, walks 8 x 28 pixel tiles with one
    persistent block an SM in a static order, copies the next tile's halo with
    zero-filling ``cp.async`` under the current tile's ``wgmma`` (bf16 in,
    f32 out; the weights by shared-memory descriptor, the pixels gathered
    into registers by ``ldmatrix`` from swizzled shared memory), and stores
    16 bytes a lane.
  * ``"fma"``: f32, or channel counts other than 64 (multiples of 8): f32
    FMAs on widened values in shared-memory tiles; in f32 it is bound by the
    FMA rate (67 TFLOP/s) and reaches about half of it.

The port's tensors are read as they are: activations are ``channels_last``
NCHW (NHWC in memory), weights are torch's (Cout, Cin, 3, 3) parameters.
Weights and bias are rounded to the input's type first, as the model's conv
does (``models/resnet.py:Conv2d``). ``pack_weights`` lays them out for the
kernel the route names, bf16 (9, Cout, Cin) or f32 (9, Cin, Cout), tap-major;
a caller whose weights seldom change packs once and passes ``packed``
(``Conv2d`` does, keyed on the weight's version). There is no backward: the
JAX package has none for this kernel either, so the wrapper refuses inputs
that need a gradient.
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
def _library() -> Tuple[ctypes.CDLL, Tuple[int, int], Tuple[int, int]]:
    """(library, (rows, columns) of the FMA kernel's pixel tile, the same
    of the tensor-core kernel's)."""
    from hairci_torch.ops._build import load_library

    lib = load_library("conv3x3")
    lib.hairci_conv3x3.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                                   + [ctypes.c_void_p] * 3
                                   + [ctypes.c_int] * 5
                                   + [ctypes.c_void_p] * 5)
    lib.hairci_conv3x3.restype = ctypes.c_int
    lib.hairci_conv3x3_mma.argtypes = ([ctypes.c_void_p] * 4
                                       + [ctypes.c_int] * 6
                                       + [ctypes.c_void_p] * 5)
    lib.hairci_conv3x3_mma.restype = ctypes.c_int
    lib.hairci_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hairci_cuda_error_string.restype = ctypes.c_char_p
    tiles = []
    for fn in (lib.hairci_conv3x3_tile, lib.hairci_conv3x3_mma_tile):
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = None
        rows, cols = ctypes.c_int(), ctypes.c_int()
        fn(ctypes.byref(rows), ctypes.byref(cols))
        tiles.append((rows.value, cols.value))
    return lib, tiles[0], tiles[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_route(cin: int, cout: int, dtype: torch.dtype) -> str:
    """Which kernel of ``csrc/conv3x3.cu`` an input takes: ``"mma"`` (tensor
    cores) for bf16 with 64 -> 64 channels, else ``"fma"``."""
    if dtype == torch.bfloat16 and cin == 64 and cout == 64:
        return "mma"
    return "fma"


def kernel_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the FMA kernel's (9, Cin, Cout) f32, tap-major
    (dy * 3 + dx), holding the values rounded to ``dtype``."""
    cout, cin = w.shape[:2]
    return (w.detach().to(dtype).float().permute(2, 3, 1, 0)
            .reshape(9, cin, cout).contiguous())


def pack_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> what the kernel that ``kernel_route`` names for
    inputs of ``dtype`` reads: ``"mma"`` bf16 (9, Cout, Cin), ``"fma"`` f32
    (9, Cin, Cout); tap-major (dy * 3 + dx), values rounded to ``dtype``."""
    cout, cin = w.shape[:2]
    if kernel_route(cin, cout, dtype) == "mma":
        return (w.detach().to(torch.bfloat16).permute(2, 3, 0, 1)
                .reshape(9, cout, cin).contiguous())
    return kernel_weights(w, dtype)


def unpack_weights(packed: torch.Tensor) -> torch.Tensor:
    """The (Cout, Cin, 3, 3) f32 weights a ``pack_weights`` result holds."""
    if packed.dtype == torch.bfloat16:          # (9, Cout, Cin)
        taps = packed.float().permute(1, 2, 0)
    else:                                       # (9, Cin, Cout)
        taps = packed.permute(2, 1, 0)
    return taps.reshape(*taps.shape[:2], 3, 3)


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None, stats: bool = False,
            packed: Optional[torch.Tensor] = None) -> ConvResult:
    """3x3 convolution, stride 1, zero padding 1, of a ``channels_last``
    (B, Cin, H, W) f32 or bf16 tensor with (Cout, Cin, 3, 3) weights and an
    optional (Cout,) bias, accumulated in f32. Returns y (B, Cout, H, W),
    ``channels_last``, in ``x``'s type; with ``stats`` also the f32 (Cout,)
    sum and sum of squares of the accumulator over B*H*W. Cin and Cout must
    be multiples of 8. ``packed`` is ``pack_weights(w, x.dtype)`` where the
    caller keeps it; it is then what the computation reads. CUDA tensors
    launch a kernel; CPU tensors take the twin. No gradient flows through
    it."""
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
    route = kernel_route(cin, cout, x.dtype)
    if packed is not None:
        want = ((9, cout, cin), torch.bfloat16) if route == "mma" else (
            (9, cin, cout), torch.float32)
        if (tuple(packed.shape), packed.dtype) != want or \
                not packed.is_contiguous():
            raise ValueError(
                f"conv3x3: packed weights {tuple(packed.shape)} "
                f"{packed.dtype} are not the {route} kernel's contiguous "
                f"{want[0]} {want[1]}")
    for name, t in (("weights", w), ("bias", b), ("packed weights", packed)):
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
        return conv3x3_reference(
            x, w if packed is None else unpack_weights(packed), b, stats)
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
    wk = pack_weights(w, x.dtype) if packed is None else packed
    bk = None if b is None else b.detach().to(x.dtype).float().contiguous()
    lib, fma_tile, mma_tile = _library()
    index = x.device.index
    tile_rows, tile_cols = mma_tile if route == "mma" else fma_tile
    tiles = B * -(-H // tile_rows) * -(-W // tile_cols)
    # persistent blocks of the tensor-core kernel; the FMA kernel's partials
    # have one row per tile
    blocks = min(tiles, _sm_count(index)) if route == "mma" else tiles
    p_sum = p_sq = o_sum = o_sq = None
    if stats:
        # one allocation: both results, then both (blocks, Cout) partials
        scratch = torch.empty((2 + 2 * blocks, cout), **f32)
        sums, sqs = scratch[0], scratch[1]
        o_sum, o_sq = sums.data_ptr(), sqs.data_ptr()
        p_sum = scratch[2].data_ptr()
        p_sq = scratch[2 + blocks].data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bias = None if bk is None else bk.data_ptr()

    def launch():
        if route == "mma":
            return lib.hairci_conv3x3_mma(
                x.data_ptr(), wk.data_ptr(), bias, out.data_ptr(), B, H, W,
                cin, cout, blocks, p_sum, p_sq, o_sum, o_sq, stream)
        return lib.hairci_conv3x3(
            x.data_ptr(), int(x.dtype == torch.bfloat16), wk.data_ptr(),
            bias, out.data_ptr(), B, H, W, cin, cout, p_sum, p_sq, o_sum,
            o_sq, stream)

    if index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(index):
            err = launch()
    if err != 0:
        raise RuntimeError(f"conv3x3 {route} kernel launch failed: "
                           + lib.hairci_cuda_error_string(err).decode())
    conv3x3.launches += 1
    conv3x3.routes[route] += 1
    y = out.permute(0, 3, 1, 2)
    return (y, sums, sqs) if stats else y


conv3x3.launches = 0
conv3x3.routes = {"mma": 0, "fma": 0}   # launches by kernel
