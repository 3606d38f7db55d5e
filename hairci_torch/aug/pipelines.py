"""Augmentation pipelines (port of the SHAM half of
``hairci/aug/pipelines.py``): the SimCLR views, the positive transform and
the hair masking of every SHAM step, and the deterministic kNN and test
transforms.

Each pipeline has a draw half (a dict of small CPU tensors from one CPU
``torch.Generator``) and an apply half that takes those draws, so a test can
inject the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from hairci_torch.aug import ops
from hairci_torch.aug.hair_masking import draw_mask, mask_hair_patches
from hairci_torch.ops.rotate import rotate_shear

Draws = Dict[str, torch.Tensor]


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
        d["crop"] = torch.stack(ops.draw_crop_params(gen, B, H, W,
                                                     self.crop_scale))
        d["flip"] = ops.draw_flags(gen, B, self.hflip_p)
        if self.cj_p > 0:
            s = self.cj_strength
            d.update({f"cj_{k}": v for k, v in ops.draw_color_jitter(
                gen, B, self.cj_bright * s, self.cj_contrast * s,
                self.cj_sat * s, self.cj_hue * s, p=self.cj_p).items()})
        if self.grayscale_p > 0:
            d["gray"] = ops.draw_flags(gen, B, self.grayscale_p)
        if self.blur_p > 0:
            d["blur_sigma"], d["blur"] = ops.draw_gaussian_blur(
                gen, B, self.blur_sigma, self.blur_p)
        if self.solarize_p > 0:
            d["solarize"] = ops.draw_flags(gen, B, self.solarize_p)
        return d

    def apply(self, x: torch.Tensor, d: Draws) -> torch.Tensor:
        x = ops.to_float(x)
        x = ops.resized_crop(x, *d["crop"], self.size)
        x = ops.hflip(x, d["flip"])
        if self.cj_p > 0:
            x = ops.color_jitter(x, {k[3:]: v for k, v in d.items()
                                     if k.startswith("cj_")})
        if self.grayscale_p > 0:
            x = ops.grayscale(x, d["gray"])
        if self.blur_p > 0:
            x = ops.gaussian_blur(
                x, self.blur_kernel or _blur_kernel_size(self.size),
                d["blur_sigma"], d["blur"])
        if self.solarize_p > 0:
            x = ops.where_image(d["solarize"], ops.solarize(x), x)
        if self.normalize:
            x = ops.normalize(x)
        return x

    def __call__(self, gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        return self.apply(x, self.draw(gen, B, H, W))


@dataclasses.dataclass(frozen=True)
class MultiViewTransform:
    """N views from N ViewConfigs."""

    views: Tuple[ViewConfig, ...]

    def draw(self, gen: torch.Generator, B: int, H: int,
             W: int) -> List[Draws]:
        return [v.draw(gen, B, H, W) for v in self.views]

    def apply(self, x: torch.Tensor, draws: List[Draws]) -> List[torch.Tensor]:
        return [v.apply(x, d) for v, d in zip(self.views, draws)]

    def __call__(self, gen: torch.Generator, x: torch.Tensor):
        B, H, W, _ = x.shape
        return self.apply(x, self.draw(gen, B, H, W))


def simclr_transform(size: int = 224) -> MultiViewTransform:
    """lightly SimCLRTransform(input_size=size), two views."""
    v = ViewConfig(size=size)
    return MultiViewTransform((v, v))


# ---------------------------------------------------------------------------
# SHAM extras
# ---------------------------------------------------------------------------

def draw_positive(gen: torch.Generator, B: int) -> Draws:
    """Rotation in +-15 degrees and blur sigma in [0.1, 0.5], per image."""
    return {"theta": ops.draw_rotation(gen, B, 15.0),
            "sigma": ops.uniform(gen, (B,), 0.1, 0.5)}


def positive_transform(x: torch.Tensor, d: Draws) -> torch.Tensor:
    """Rotation +-15 degrees + GaussianBlur(3, sigma) of the positive view,
    on the normalised batch: the rotate kernel on a card, its twin on the
    CPU (``rotate_shear_pallas(..., blur_sigma=...)`` on the TPU). The
    views come out of the SimCLR ops in whatever strides their last op left
    (after ``gaussian_blur``, NCHW order); the kernel gathers at those
    strides and writes a contiguous NHWC batch."""
    return rotate_shear(x, ops.to_device(d["theta"], x.device),
                        max_degrees=15.0,
                        blur_sigma=ops.to_device(d["sigma"], x.device))


def draw_positive_masking(gen: torch.Generator, B: int, H: int, W: int,
                          patch_size: int = 32,
                          mask_ratio_range=(0.1, 0.2)) -> Draws:
    ratio, scores = draw_mask(gen, B, H, W, patch_size, mask_ratio_range)
    return {"ratio": ratio, "scores": scores}


def positive_masking_transform(x: torch.Tensor, d: Draws,
                               patch_size: int = 32,
                               threshold: float = 0.01) -> torch.Tensor:
    """PositiveMaskingTransform: zero a drawn subset of hair patches."""
    return mask_hair_patches(x, d["ratio"], d["scores"], patch_size,
                             threshold)


def knn_transform(x: torch.Tensor, size: int = 224) -> torch.Tensor:
    """CenterCrop(size) + ToTensor + ImageNet normalize (deterministic)."""
    return ops.normalize(ops.center_crop(ops.to_float(x), size))


def test_transform(x: torch.Tensor, size: int = 224, mean=ops.IMAGENET_MEAN,
                   std=ops.IMAGENET_STD) -> torch.Tensor:
    """``get_test_transform``: Resize((size, size)) + normalize."""
    return ops.normalize(ops.resize(ops.to_float(x), (size, size)), mean, std)


test_transform.__test__ = False  # a transform, not a test, for pytest
