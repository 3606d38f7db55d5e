"""Fused 3-shear nearest rotation + 3-tap blur: a CUDA kernel and its twin.

Kernel: ``csrc/rotate.cu``, written by hand for Hopper (``sm_90a``), built
with nvcc at first use and bound with ctypes. It replaces the TPU kernel
``hairci/ops/rotate_pallas.py:rotate_shear_pallas`` (``_rotate_kernel``).

What bounds it on the card: one read and one write of the f32 NHWC batch.
The TPU kernel shifts whole images through a ladder of rolls because gathers
were slow there. The CUDA kernel gives each block a band of full-width rows
of one image: it writes the image's shifts into tables in shared memory
(H + W of them, so a gathered pixel costs three table reads and three range
tests), gathers the band once from ``x`` at ``x``'s own strides, blurs it in
shared memory once per value, and writes it as 16-byte stores. It computes
the shear coefficients and blur weights itself, as the TPU kernel does, so a
call is one allocation and one launch. The plain twin runs the three passes
as three gathers over the batch, and the blur as separate elementwise
passes, each a full round trip through device memory.

Semantics are those of ``hairci.aug.ops.rotate_shear(order=0)``: the Paeth
decomposition, shifts rounded half up (``floor(t + 0.5)``, never
``torch.round``) and clamped to +-max_shift, fill outside; then, with
``blur_sigma``, the separable blur ``w1 * v + w0 * (up + down)`` of
``_blur3``, rows first, reflect edges.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional, Tuple

import torch


@functools.lru_cache(maxsize=None)
def max_shifts(H: int, W: int, max_degrees: float) -> Tuple[int, int]:
    """Static shift bounds (mx, my) for |theta| <= max_degrees
    (``rotate_pallas.py:106-108``)."""
    t_max = math.radians(max_degrees)
    mx = int(math.ceil(math.tan(t_max / 2) * (H / 2))) + 1
    my = int(math.ceil(math.sin(t_max) * (W / 2))) + 1
    return mx, my


def shear_coefficients(theta: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha, beta) = (-tan(theta/2), sin(theta)) in f32: the twin's; the
    kernel makes the same operations itself."""
    theta = theta.float()
    return -torch.tan(theta / 2.0), torch.sin(theta)


def blur3_weights(sigma: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w0, w1): the normalised 3-tap Gaussian [w0, w1, w0] per image."""
    sigma = sigma.float()
    e = torch.exp(-1.0 / (2.0 * sigma * sigma))
    denom = 1.0 + 2.0 * e
    return e / denom, 1.0 / denom


def _shift(v: torch.Tensor, n: torch.Tensor, axis: int, max_shift: int,
           fill: float) -> torch.Tensor:
    """out[pos] = v[pos - n] along ``axis`` (1 rows, 2 columns) of a
    (B, H, W, C) batch; ``n`` broadcasts over (B, H, W) with extent 1 on
    ``axis``. The roll is by the clamped shift, mod the axis length, and the
    unclamped source decides the fill -- the roll ladder's semantics."""
    size = v.shape[axis]
    shape = [1, 1, 1]
    shape[axis] = size
    pos = torch.arange(size, device=v.device).reshape(shape)
    valid = ((pos - n) >= 0) & ((pos - n) <= size - 1)
    idx = torch.remainder(pos - n.clamp(-max_shift, max_shift), size)
    idx = idx.expand(v.shape[:3])
    out = torch.gather(v, axis, idx[..., None].expand(v.shape))
    return torch.where(valid[..., None], out, torch.full_like(out, fill))


def rotate_shear_reference(x: torch.Tensor, theta: torch.Tensor,
                           fill: float = 0.0, max_degrees: float = 45.0,
                           blur_sigma: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain twin: three shift passes, then the optional 3-tap blur."""
    B, H, W, C = x.shape
    alpha, beta = shear_coefficients(theta)
    mx, my = max_shifts(H, W, max_degrees)
    rows_y = torch.arange(H, dtype=torch.float32, device=x.device) - (H - 1) / 2.0
    cols_x = torch.arange(W, dtype=torch.float32, device=x.device) - (W - 1) / 2.0
    nx = torch.floor(alpha[:, None] * rows_y[None, :] + 0.5).long()[:, :, None]
    ny = torch.floor(beta[:, None] * cols_x[None, :] + 0.5).long()[:, None, :]
    v = x.float()
    v = _shift(v, nx, 2, mx, fill)
    v = _shift(v, ny, 1, my, fill)
    v = _shift(v, nx, 2, mx, fill)
    if blur_sigma is None:
        return v
    w0, w1 = (w.reshape(B, 1, 1, 1) for w in blur3_weights(blur_sigma))
    up = torch.cat([v[:, 1:2], v[:, :-1]], 1)       # row i-1, reflect at 0
    down = torch.cat([v[:, 1:], v[:, -2:-1]], 1)    # row i+1, reflect at H-1
    v = w1 * v + w0 * (up + down)
    left = torch.cat([v[:, :, 1:2], v[:, :, :-1]], 2)
    right = torch.cat([v[:, :, 1:], v[:, :, -2:-1]], 2)
    return w1 * v + w0 * (left + right)


@functools.lru_cache(maxsize=None)
def _library() -> Tuple[Callable, Callable]:
    """(the launch function, the error-string function) of the built
    library, with their argument types set once."""
    from hairci_torch.ops._build import load_library

    lib = load_library("rotate")
    fn = lib.hairci_rotate
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.hairci_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hairci_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.hairci_cuda_error_string


_TOO_WIDE = -1  # hairci_rotate: one band row does not fit in shared memory


def rotate_shear(x: torch.Tensor, theta: torch.Tensor, fill: float = 0.0,
                 max_degrees: float = 45.0,
                 blur_sigma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate each image of an f32 (B, H, W, C) batch, at any strides, by
    ``theta`` (B,) radians, |theta| <= max_degrees, then blur with
    ``blur_sigma`` (B,) if given; a contiguous batch out. CUDA tensors launch
    the kernel (theta and blur_sigma f32 and contiguous there: the kernel
    reads them as they are); CPU tensors take the twin."""
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"rotate_shear: need an f32 (B, H, W, C) batch, got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, H, W, C = x.shape
    dev = x.device
    for name, t in (("theta", theta), ("blur_sigma", blur_sigma)):
        if t is not None and (t.shape != (B,) or t.device != dev):
            raise ValueError(f"rotate_shear: {name} must be ({B},) on "
                             f"{dev}, got {tuple(t.shape)} on {t.device}")
    if blur_sigma is not None and (H < 2 or W < 2):
        raise ValueError("rotate_shear: the blur needs H, W >= 2")
    if dev.type == "cpu":
        return rotate_shear_reference(x, theta, fill, max_degrees, blur_sigma)
    if dev.type != "cuda":
        raise ValueError(f"rotate_shear: no kernel for {dev}")
    for name, t in (("theta", theta), ("blur_sigma", blur_sigma)):
        if t is not None and (t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"rotate_shear: {name} must be f32 and "
                             f"contiguous, got {t.dtype} {t.stride()}")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    mx, my = max_shifts(H, W, max_degrees)
    index = dev.index
    launch, error_string = _library()
    args = (x.data_ptr(), *x.stride(), theta.data_ptr(),
            None if blur_sigma is None else blur_sigma.data_ptr(),
            out.data_ptr(), B, H, W, C, mx, my, fill,
            torch.cuda.current_stream(dev).cuda_stream)
    if index == torch.cuda.current_device():
        err = launch(*args)
    else:
        with torch.cuda.device(index):
            err = launch(*args)
    if err == _TOO_WIDE:
        raise ValueError(f"rotate_shear: a row of {W} x {C} floats does not "
                         f"fit the kernel's shared memory")
    if err != 0:
        raise RuntimeError("rotate_shear kernel launch failed: "
                           + error_string(err).decode())
    rotate_shear.launches += 1
    return out


rotate_shear.launches = 0
