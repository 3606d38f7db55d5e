"""A frozen copy of the port's augmentations, in plain PyTorch.

The SHAM step draws every random parameter from one CPU generator and
applies it on the device. The reference makes the same draws from the same
generator and applies them with this copy, taken from
``hairci_torch/aug/{ops,hair_masking,pipelines}.py`` and the plain twin of
``hairci_torch/ops/rotate.py`` as they stood when the benchmark was
written, so that a later change to the program cannot move it. Nothing here
imports the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Draws = Dict[str, torch.Tensor]

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
    return t.to(device)


def uniform(gen: torch.Generator, shape, lo: float = 0.0,
            hi: float = 1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen) * (hi - lo) + lo




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




def rgb_to_grayscale(x: torch.Tensor, keep_channels: bool = True):
    """ITU-R 601-2 luma (PIL convert("L")), as the fused multiply-add chain
    XLA makes of the JAX package's einsum: bitwise the same on the CPU."""
    w = torch.tensor([0.587, 0.114], dtype=x.dtype, device=x.device)
    g = torch.addcmul(torch.addcmul(x[..., 0] * 0.299, x[..., 1], w[0]),
                      x[..., 2], w[1])[..., None]
    return g.expand(*g.shape[:-1], 3) if keep_channels else g


def grayscale(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    return where_image(sel, rgb_to_grayscale(x), x)




def solarize(x: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    return torch.where(x >= threshold, 1.0 - x, x)




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





# ---------------------------------------------------------------------------
# rotation (the plain twin of the rotate kernel)
# ---------------------------------------------------------------------------

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
    rows_y = (torch.arange(H, dtype=torch.float32, device=x.device)
              - (H - 1) / 2.0)
    cols_x = (torch.arange(W, dtype=torch.float32, device=x.device)
              - (W - 1) / 2.0)
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



# ---------------------------------------------------------------------------
# hair masking
# ---------------------------------------------------------------------------

def patch_means(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, P) mean over each patch and its channels."""
    B, H, W, C = x.shape
    ph, pw = H // patch_size, W // patch_size
    x = x[:, :ph * patch_size, :pw * patch_size, :]
    x = x.reshape(B, ph, patch_size, pw, patch_size, C)
    return x.mean(dim=(2, 4, 5)).reshape(B, ph * pw)


def draw_mask(gen: torch.Generator, B: int, H: int, W: int,
              patch_size: int = 32, mask_ratio_range=(0.1, 0.2)
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ratio (B,), scores (B, P))."""
    P = (H // patch_size) * (W // patch_size)
    return (uniform(gen, (B,), mask_ratio_range[0], mask_ratio_range[1]),
            uniform(gen, (B, P)))


def mask_hair_patches(x: torch.Tensor, ratio: torch.Tensor,
                      scores: torch.Tensor, patch_size: int = 32,
                      threshold: float = 0.01) -> torch.Tensor:
    """Zero the drawn subset of each image's hair patches."""
    B, H, W, C = x.shape
    ph, pw = H // patch_size, W // patch_size
    P = ph * pw
    ratio, scores = to_device(ratio, x.device), to_device(scores, x.device)
    hair = patch_means(x, patch_size) > threshold               # (B, P)
    num_mask = torch.floor(ratio * hair.sum(1)).long()           # (B,)
    scores = torch.where(hair, scores, torch.full_like(scores, 2.0))
    kth = torch.sort(scores, dim=1).values.gather(
        1, torch.clamp(num_mask - 1, 0, P - 1)[:, None])
    masked = hair & (scores <= kth) & (num_mask[:, None] > 0)
    keep = (1.0 - masked.to(x.dtype)).reshape(B, ph, pw)
    keep = keep.repeat_interleave(patch_size, 1).repeat_interleave(
        patch_size, 2)
    keep = torch.nn.functional.pad(
        keep, (0, W - keep.shape[2], 0, H - keep.shape[1]), value=1.0)
    return x * keep[..., None]


# ---------------------------------------------------------------------------
# one SimCLR view
# ---------------------------------------------------------------------------

def _blur_kernel_size(input_size: int) -> int:
    # lightly uses kernel ~ 0.1 * input size, odd
    k = int(0.1 * input_size)
    return k + 1 if k % 2 == 0 else max(k, 3)


@dataclasses.dataclass(frozen=True)
class ViewConfig:
    """One augmented view. Defaults = lightly SimCLRTransform view."""

    size: int = 224
    crop_scale: Tuple[float, float] = (0.08, 1.0)
    hflip_p: float = 0.5
    cj_p: float = 0.8
    cj_strength: float = 1.0
    cj_bright: float = 0.8
    cj_contrast: float = 0.8
    cj_sat: float = 0.8
    cj_hue: float = 0.2
    grayscale_p: float = 0.2
    blur_p: float = 0.5
    blur_sigma: Tuple[float, float] = (0.1, 2.0)
    blur_kernel: int | None = None  # None -> lightly's 0.1*size rule
    solarize_p: float = 0.0
    normalize: bool = True

    def draw(self, gen: torch.Generator, B: int, H: int, W: int) -> Draws:
        d: Draws = {}
        d["crop"] = torch.stack(draw_crop_params(gen, B, H, W,
                                                     self.crop_scale))
        d["flip"] = draw_flags(gen, B, self.hflip_p)
        if self.cj_p > 0:
            s = self.cj_strength
            d.update({f"cj_{k}": v for k, v in draw_color_jitter(
                gen, B, self.cj_bright * s, self.cj_contrast * s,
                self.cj_sat * s, self.cj_hue * s, p=self.cj_p).items()})
        if self.grayscale_p > 0:
            d["gray"] = draw_flags(gen, B, self.grayscale_p)
        if self.blur_p > 0:
            d["blur_sigma"], d["blur"] = draw_gaussian_blur(
                gen, B, self.blur_sigma, self.blur_p)
        if self.solarize_p > 0:
            d["solarize"] = draw_flags(gen, B, self.solarize_p)
        return d

    def apply(self, x: torch.Tensor, d: Draws) -> torch.Tensor:
        x = to_float(x)
        x = resized_crop(x, *d["crop"], self.size)
        x = hflip(x, d["flip"])
        if self.cj_p > 0:
            x = color_jitter(x, {k[3:]: v for k, v in d.items()
                                     if k.startswith("cj_")})
        if self.grayscale_p > 0:
            x = grayscale(x, d["gray"])
        if self.blur_p > 0:
            x = gaussian_blur(
                x, self.blur_kernel or _blur_kernel_size(self.size),
                d["blur_sigma"], d["blur"])
        if self.solarize_p > 0:
            x = where_image(d["solarize"], solarize(x), x)
        if self.normalize:
            x = normalize(x)
        return x

    def __call__(self, gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        return self.apply(x, self.draw(gen, B, H, W))




def draw_rotation(gen: torch.Generator, B: int,
                  degrees: float = 15.0) -> torch.Tensor:
    """(B,) angles in radians, uniform in [-degrees, degrees]."""
    return uniform(gen, (B,), -degrees, degrees) * (math.pi / 180.0)


# ---------------------------------------------------------------------------
# the SHAM step's draws and transforms
# ---------------------------------------------------------------------------

def sham_draw(gen: torch.Generator, B: int, H: int, W: int, img_size: int,
              mask_ratio_range: Tuple[float, float]) -> Dict[str, object]:
    """``SHAMRecipe.draw``: two SimCLR views, the permutation, the
    positive's rotation and blur, the masking."""
    view = ViewConfig(size=img_size)
    return {
        "views": [view.draw(gen, B, H, W), view.draw(gen, B, H, W)],
        "perm": torch.randperm(B, generator=gen),
        "positive": {"theta": draw_rotation(gen, B, 15.0),
                     "sigma": uniform(gen, (B,), 0.1, 0.5)},
        "mask": dict(zip(("ratio", "scores"),
                         draw_mask(gen, B, img_size, img_size, 32,
                                   mask_ratio_range))),
    }


def sham_views(images: torch.Tensor, draws, img_size: int):
    view = ViewConfig(size=img_size)
    return [view.apply(images, d) for d in draws["views"]]


def positive_transform(x: torch.Tensor, d: Draws) -> torch.Tensor:
    return rotate_shear_reference(x, to_device(d["theta"], x.device),
                                  max_degrees=15.0,
                                  blur_sigma=to_device(d["sigma"], x.device))


def positive_masking(x: torch.Tensor, d: Draws) -> torch.Tensor:
    return mask_hair_patches(x, d["ratio"], d["scores"], 32, 0.01)
