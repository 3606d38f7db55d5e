"""Batched augmentation primitives on tensors (port of ``hairci/aug/ops.py``).

Images are (B, H, W, C) float32 in [0, 1] at the public boundary (NHWC, as
in the JAX package). Each random op is split in two:

  * a draw half, ``draw_*(gen, B, ...)``, which takes its random parameters
    from an explicit CPU ``torch.Generator`` and returns small CPU tensors
    (JAX's key splits become one generator consumed in a fixed order);
  * an apply half, which takes those parameters as tensors on any device.

The tests hold each apply half against JAX on JAX's own draws. ``random_*``
composes the two.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from hairci_torch.ops import rotate as _rotate

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_F32_EPS = float(torch.finfo(torch.float32).eps)


def to_float(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1] (torchvision ToTensor)."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)


def normalize(x: torch.Tensor, mean=IMAGENET_MEAN,
              std=IMAGENET_STD) -> torch.Tensor:
    """(x - mean) / std over the trailing channel axis (NHWC)."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A drawn CPU tensor on ``device``; to a card through pinned memory and
    without waiting for the card."""
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def uniform(gen: torch.Generator, shape, lo: float = 0.0,
            hi: float = 1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """Exact torchvision CenterCrop for H, W >= size (zero-pads if smaller)."""
    B, H, W, C = x.shape
    if H < size or W < size:
        ph, pw = max(size - H, 0), max(size - W, 0)
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        B, H, W, C = x.shape
    top = int(round((H - size) / 2.0))
    left = int(round((W - size) / 2.0))
    return x[:, top:top + size, left:left + size, :]


# ---------------------------------------------------------------------------
# random resized crop
# ---------------------------------------------------------------------------

def draw_crop_params(gen: torch.Generator, B: int, H: int, W: int,
                     scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                     attempts: int = 10) -> Tuple[torch.Tensor, ...]:
    """torchvision RandomResizedCrop.get_params per image, over 10 attempts
    at once (``_sample_crop_params``): (top, left, h, w), each (B,) f32."""
    area = float(H * W)
    target = area * uniform(gen, (B, attempts), scale[0], scale[1])
    log_ratio = uniform(gen, (B, attempts), math.log(ratio[0]),
                        math.log(ratio[1]))
    aspect = torch.exp(log_ratio)
    w = torch.sqrt(target * aspect)
    h = torch.sqrt(target / aspect)
    valid = (w <= W) & (h <= H) & (w > 0) & (h > 0)
    idx = valid.int().argmax(1, keepdim=True)  # first valid attempt
    any_valid = valid.any(1)
    in_ratio = float(W) / float(H)
    if in_ratio < ratio[0]:
        fb_w, fb_h = float(W), W / ratio[0]
    elif in_ratio > ratio[1]:
        fb_h, fb_w = float(H), H * ratio[1]
    else:
        fb_w, fb_h = float(W), float(H)
    w_sel = torch.where(any_valid, w.gather(1, idx)[:, 0], fb_w)
    h_sel = torch.where(any_valid, h.gather(1, idx)[:, 0], fb_h)
    u_i, u_j = uniform(gen, (B,)), uniform(gen, (B,))
    top = torch.where(any_valid, u_i * (H - h_sel), (H - h_sel) / 2.0)
    left = torch.where(any_valid, u_j * (W - w_sel), (W - w_sel) / 2.0)
    return top, left, h_sel, w_sel


def _weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                translation: torch.Tensor) -> torch.Tensor:
    """(B, in, out) bilinear antialiased resampling weights, per image:
    ``compute_weight_mat`` of ``jax.image.scale_and_translate`` (sample
    positions, a triangle kernel widened by 1/scale when downsampling,
    renormalised, zero where the sample lies outside [-0.5, in - 0.5])."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev)
                 + 0.5)[None, :] * inv_scale[:, None]
                - (translation * inv_scale)[:, None] - 0.5)       # (B, out)
    pos = torch.arange(in_size, dtype=torch.float32, device=dev)
    dist = (torch.abs(sample_f[:, None, :] - pos[None, :, None])
            / kernel_scale[:, None, None])
    weights = torch.clamp(1 - dist, min=0)
    total = weights.sum(1, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * _F32_EPS,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def resized_crop(x: torch.Tensor, top, left, h, w, size: int) -> torch.Tensor:
    """Apply half of ``random_resized_crop``: crop box (top, left, h, w) of
    each image resampled to (size, size), as two batched f32 matmuls."""
    B, H, W, C = x.shape
    top, left, h, w = (to_device(t.float(), x.device)
                       for t in (top, left, h, w))
    sy, sx = size / h, size / w
    wy = _weight_mat(H, size, sy, -top * sy)          # (B, H, size)
    wx = _weight_mat(W, size, sx, -left * sx)         # (B, W, size)
    t = torch.einsum("bhy,bhwc->bywc", wy, x.float())
    return torch.einsum("bwx,bywc->byxc", wx, t)


def resize(x: torch.Tensor, size: Tuple[int, int], method: str = "bilinear",
           antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize`` of an (B, H, W, C) batch to (size[0], size[1]):
    bilinear, antialiased, through the same weight matrices as the crop."""
    if method != "bilinear" or not antialias:
        raise NotImplementedError("resize: only bilinear with antialias is "
                                  "ported")
    B, H, W, C = x.shape
    zero = torch.zeros(1, device=x.device)
    wy, wx = (_weight_mat(n, out, torch.full((1,), out / n, device=x.device),
                          zero)[0] for n, out in ((H, size[0]), (W, size[1])))
    t = torch.einsum("hy,bhwc->bywc", wy, x.float())
    return torch.einsum("wx,bywc->byxc", wx, t)


def random_resized_crop(gen, x, size, scale=(0.08, 1.0),
                        ratio=(3.0 / 4.0, 4.0 / 3.0)):
    B, H, W, _ = x.shape
    return resized_crop(x, *draw_crop_params(gen, B, H, W, scale, ratio),
                        size)


# ---------------------------------------------------------------------------
# flips / grayscale / solarize
# ---------------------------------------------------------------------------

def draw_flags(gen: torch.Generator, B: int, p: float) -> torch.Tensor:
    """(B,) bool: u < p per image (every RandomApply of the JAX package)."""
    return uniform(gen, (B,)) < p


def where_image(sel, a, b):
    sel = to_device(sel, a.device).reshape(-1, *([1] * (a.dim() - 1)))
    return torch.where(sel, a, b)


def hflip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return where_image(flip, x.flip(2), x)


def random_hflip(gen, x, p: float = 0.5):
    return hflip(x, draw_flags(gen, x.shape[0], p))


def rgb_to_grayscale(x: torch.Tensor, keep_channels: bool = True):
    """ITU-R 601-2 luma (PIL convert("L")), as the fused multiply-add chain
    XLA makes of the JAX package's einsum: bitwise the same on the CPU."""
    w = torch.tensor([0.587, 0.114], dtype=x.dtype, device=x.device)
    g = torch.addcmul(torch.addcmul(x[..., 0] * 0.299, x[..., 1], w[0]),
                      x[..., 2], w[1])[..., None]
    return g.expand(*g.shape[:-1], 3) if keep_channels else g


def grayscale(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    return where_image(sel, rgb_to_grayscale(x), x)


def random_grayscale(gen, x, p: float = 0.2):
    return grayscale(x, draw_flags(gen, x.shape[0], p))


def solarize(x: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    return torch.where(x >= threshold, 1.0 - x, x)


def random_solarize(gen, x, p: float = 0.2, threshold: float = 0.5):
    return where_image(draw_flags(gen, x.shape[0], p),
                        solarize(x, threshold), x)


# ---------------------------------------------------------------------------
# color jitter
# ---------------------------------------------------------------------------

def _factor(f, x):
    return to_device(f, x.device).reshape(-1, 1, 1, 1)


def _blend(a, b, f):
    return torch.clamp(a * f + b * (1.0 - f), 0.0, 1.0)


def adjust_brightness(x, factor):
    return _blend(x, torch.zeros_like(x), _factor(factor, x))


def adjust_contrast(x, factor):
    mean = rgb_to_grayscale(x, keep_channels=False).mean(dim=(1, 2, 3),
                                                         keepdim=True)
    return _blend(x, mean, _factor(factor, x))


def adjust_saturation(x, factor):
    return _blend(x, rgb_to_grayscale(x), _factor(factor, x))


def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.max(-1).values
    minc = x.min(-1).values
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.clamp(delta, min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)  # floor-mod, as jnp's %
    return torch.where(delta == 0, zero, h), s, maxc


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.int(), 6)

    def select(*vals):  # jnp.select over i == 0 .. 5
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], -1)


def adjust_hue(x, factor):
    """factor in [-0.5, 0.5]: hue rotation through HSV."""
    h, s, v = _rgb_to_hsv(x)
    h = torch.remainder(h + to_device(factor, x.device).reshape(-1, 1, 1), 1.0)
    return _hsv_to_rgb(h, s, v)


def draw_color_jitter(gen: torch.Generator, B: int, brightness: float = 0.8,
                      contrast: float = 0.8, saturation: float = 0.8,
                      hue: float = 0.2, p: float = 0.8
                      ) -> Dict[str, torch.Tensor]:
    """Per-image factors, one op order per batch, and the RandomApply flag."""
    return {
        "brightness": uniform(gen, (B,), max(0, 1 - brightness),
                              1 + brightness),
        "contrast": uniform(gen, (B,), max(0, 1 - contrast), 1 + contrast),
        "saturation": uniform(gen, (B,), max(0, 1 - saturation),
                              1 + saturation),
        "hue": uniform(gen, (B,), -hue, hue),
        "order": torch.randperm(4, generator=gen),
        "apply": draw_flags(gen, B, p),
    }


def color_jitter(x: torch.Tensor, d: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Apply half of torchvision ColorJitter in RandomApply: the four
    adjustments in ``d["order"]`` (one order for the batch, as in JAX)."""
    ops = [lambda im: adjust_brightness(im, d["brightness"]),
           lambda im: adjust_contrast(im, d["contrast"]),
           lambda im: adjust_saturation(im, d["saturation"]),
           lambda im: adjust_hue(im, d["hue"])]
    y = x
    for i in d["order"].tolist():
        y = ops[i](y)
    return where_image(d["apply"], y, x)


# ---------------------------------------------------------------------------
# gaussian blur
# ---------------------------------------------------------------------------

def draw_gaussian_blur(gen: torch.Generator, B: int,
                       sigma_range=(0.1, 2.0), p: float = 0.5
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigma (B,), apply (B,) bool)."""
    return uniform(gen, (B,), sigma_range[0], sigma_range[1]), \
        draw_flags(gen, B, p)


def gaussian_blur(x: torch.Tensor, kernel_size: int, sigma: torch.Tensor,
                  apply: torch.Tensor) -> torch.Tensor:
    """Separable depthwise Gaussian blur with a sigma per image and reflect
    padding: rows, then columns, as two grouped convs over B*C channels."""
    B, H, W, C = x.shape
    sigma = to_device(sigma.float(), x.device)
    half = kernel_size // 2
    grid = torch.arange(-half, half + 1, dtype=torch.float32, device=x.device)
    kern = torch.exp(-(grid[None, :] ** 2) / (2.0 * sigma[:, None] ** 2))
    kern = (kern / kern.sum(1, keepdim=True)).repeat_interleave(C, 0)
    folded = x.permute(0, 3, 1, 2).reshape(1, B * C, H, W)
    folded = F.pad(folded, (half, half, half, half), mode="reflect")
    out = F.conv2d(folded, kern.reshape(B * C, 1, kernel_size, 1),
                   groups=B * C)
    out = F.conv2d(out, kern.reshape(B * C, 1, 1, kernel_size), groups=B * C)
    blurred = out.reshape(B, C, H, W).permute(0, 2, 3, 1)
    return where_image(apply, blurred, x)


def random_gaussian_blur(gen, x, kernel_size, sigma_range=(0.1, 2.0),
                         p: float = 0.5):
    return gaussian_blur(x, kernel_size,
                         *draw_gaussian_blur(gen, x.shape[0], sigma_range, p))


# ---------------------------------------------------------------------------
# rotation (positive_transform: RandomRotation +-15 degrees)
# ---------------------------------------------------------------------------

def _shift_linear(v: torch.Tensor, t: torch.Tensor, axis: int,
                  max_shift: int, fill: float) -> torch.Tensor:
    """``_axis_shift``'s ``order=1`` branch on a (B, H, W, C) batch:
    out[pos] = (1 - f) v[pos - n] + f v[pos - n - 1] along ``axis`` (1 rows,
    2 columns), n = floor(t), f = t - n; ``t`` broadcasts over (B, H, W) with
    extent 1 on ``axis``. As in the roll ladder, n is clamped to
    +-max_shift for the roll (mod the axis length) and the unclamped source
    decides the fill; the second tap is the first rolled by one more."""
    size = v.shape[axis]
    shape = [1, 1, 1]
    shape[axis] = size
    pos = torch.arange(size, device=v.device).reshape(shape)
    n = torch.floor(t)
    f = (t - n)[..., None]
    n = n.long()
    src = pos - n
    nc = n.clamp(-max_shift, max_shift)
    taps = []
    for k, valid in ((0, (src >= 0) & (src <= size - 1)),
                     (1, (src - 1 >= 0) & (src - 1 <= size - 1))):
        idx = torch.remainder(pos - nc - k, size).expand(v.shape[:3])
        y = torch.gather(v, axis, idx[..., None].expand(v.shape))
        taps.append(torch.where(valid[..., None], y, torch.full_like(y, fill)))
    return taps[0] * (1.0 - f) + taps[1] * f


def rotate_shear(x: torch.Tensor, theta: torch.Tensor, order: int = 0,
                 fill: float = 0.0, max_degrees: float = 45.0):
    """Per-image rotation by the Paeth 3-shear (``theta`` in radians, (B,)),
    ``max_degrees`` the static bound on |theta|.

    ``order=0`` (nearest, torchvision RandomRotation's default): the rotate
    kernel on a CUDA tensor, its plain twin on a CPU tensor.

    ``order=1`` (linear interpolation in each shear pass): plain torch on
    every device. The JAX package has no TPU kernel for it either (its Pallas
    rotate is nearest only), so this is the port of plain JAX, not a
    fallback; no caller of either package uses it on the training path."""
    if order == 0:
        return _rotate.rotate_shear(x, to_device(theta, x.device),
                                    fill=fill, max_degrees=max_degrees)
    if order != 1:
        raise ValueError(f"order must be 0 or 1, got {order}")
    B, H, W, C = x.shape
    alpha, beta = _rotate.shear_coefficients(to_device(theta, x.device))
    mx, my = _rotate.max_shifts(H, W, max_degrees)
    rows_y = torch.arange(H, dtype=torch.float32, device=x.device) - (H - 1) / 2.0
    cols_x = torch.arange(W, dtype=torch.float32, device=x.device) - (W - 1) / 2.0
    tx = (alpha[:, None] * rows_y[None, :])[:, :, None]     # (B, H, 1)
    ty = (beta[:, None] * cols_x[None, :])[:, None, :]      # (B, 1, W)
    v = x.float()
    v = _shift_linear(v, tx, 2, mx, fill)
    v = _shift_linear(v, ty, 1, my, fill)
    return _shift_linear(v, tx, 2, mx, fill)


def draw_rotation(gen: torch.Generator, B: int,
                  degrees: float = 15.0) -> torch.Tensor:
    """(B,) angles in radians, uniform in [-degrees, degrees]."""
    return uniform(gen, (B,), -degrees, degrees) * (math.pi / 180.0)


def random_rotate(gen, x, degrees: float = 15.0, fill: float = 0.0):
    """Random rotation by the shear route (``rotate_shear``)."""
    return rotate_shear(x, draw_rotation(gen, x.shape[0], degrees), fill=fill,
                        max_degrees=max(degrees, 1e-3))
