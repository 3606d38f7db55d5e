"""Augmentation pipelines (port of part of ``hairci/aug/pipelines.py``):
the SimCLR views, SupCon's two views, the single view of MAE and SimMIM,
BYOL's and DenseCL's two views, DINO's and MSN's multi-crop views, the positive transform and the hair
masking of every SHAM step, the negative transform no recipe calls, and the
deterministic kNN and test transforms.

Each pipeline has a draw half (a dict of small CPU tensors from one CPU
``torch.Generator``) and an apply half that takes those draws, so a test can
inject the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from hairci_torch.aug import ops
from hairci_torch.aug.hair_masking import draw_mask, mask_hair_patches
from hairci_torch.ops.rotate import rotate_shear

Draws = Dict[str, torch.Tensor]


def shard_draws(d: Draws, lo: int, hi: int) -> Draws:
    """Images ``[lo, hi)`` of one draw dict (a view's, the positive's or the
    masking's): every per-image draw cut to those rows -- ``crop`` is
    (4, B), the rest lead with B -- and the colour jitter's one op order for
    the batch kept whole. A data-parallel rank draws for the global batch
    and keeps its rows, so its views are the one-process run's."""
    return {k: v[:, lo:hi] if k == "crop" else v if k == "cj_order"
            else v[lo:hi] for k, v in d.items()}


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

    views: Tuple[Any, ...]   # ViewConfig or SupConView

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


def mae_transform(size: int = 224) -> MultiViewTransform:
    """lightly MAETransform: one view, RandomResizedCrop(scale=(0.2, 1)) and
    hflip only, then normalize."""
    v = ViewConfig(size=size, crop_scale=(0.2, 1.0), cj_p=0.0,
                   grayscale_p=0.0, blur_p=0.0)
    return MultiViewTransform((v,))


def simmim_transform(size: int = 224) -> MultiViewTransform:
    """SimMIM's view: the same as MAE's."""
    return mae_transform(size)


def byol_transform(size: int = 224) -> MultiViewTransform:
    """lightly BYOLTransform: two views, blurred with p = 1.0 and 0.1, the
    second solarized with p = 0.2."""
    v1 = ViewConfig(size=size, crop_scale=(0.08, 1.0), cj_bright=0.4,
                    cj_contrast=0.4, cj_sat=0.2, cj_hue=0.1, blur_p=1.0,
                    solarize_p=0.0)
    v2 = dataclasses.replace(v1, blur_p=0.1, solarize_p=0.2)
    return MultiViewTransform((v1, v2))


def densecl_transform(size: int = 224) -> MultiViewTransform:
    """lightly DenseCLTransform: SimCLR's views at half the jitter."""
    v = ViewConfig(size=size, cj_bright=0.4, cj_contrast=0.4, cj_sat=0.4,
                   cj_hue=0.1)
    return MultiViewTransform((v, v))


def dino_transform(global_size: int = 224, local_size: int = 96,
                   n_local: int = 6) -> MultiViewTransform:
    """lightly DINOTransform: two global crops (the second solarized with
    p = 0.2, blurred with p = 0.1) and ``n_local`` local crops."""
    g1 = ViewConfig(size=global_size, crop_scale=(0.4, 1.0), cj_bright=0.4,
                    cj_contrast=0.4, cj_sat=0.2, cj_hue=0.1, blur_p=1.0)
    g2 = dataclasses.replace(g1, blur_p=0.1, solarize_p=0.2)
    loc = dataclasses.replace(g1, size=local_size, crop_scale=(0.05, 0.4),
                              blur_p=0.5)
    return MultiViewTransform((g1, g2) + (loc,) * n_local)


def msn_transform(size: int = 224, focal_size: int = 96,
                  n_focal: int = 10) -> MultiViewTransform:
    """lightly MSNTransform: two random views and ``n_focal`` small-crop
    focal views."""
    v = ViewConfig(size=size, crop_scale=(0.3, 1.0), cj_bright=0.8,
                   cj_contrast=0.8, cj_sat=0.8, cj_hue=0.2, blur_p=0.5)
    f = dataclasses.replace(v, size=focal_size, crop_scale=(0.05, 0.3))
    return MultiViewTransform((v, v) + (f,) * n_focal)


@dataclasses.dataclass(frozen=True)
class SupConView:
    """One view of ``TwoCropTransform(get_train_transform)``: hflip (p=0.5),
    ColorJitter(0.4, 0.4, 0.4, 0.1) applied with p=0.8, a bilinear resize to
    ``size`` (no crop: the reference comments its crop out), normalize."""

    size: int
    mean: Tuple[float, ...]
    std: Tuple[float, ...]

    def draw(self, gen: torch.Generator, B: int, H: int, W: int) -> Draws:
        d: Draws = {"flip": ops.draw_flags(gen, B, 0.5)}
        d.update({f"cj_{k}": v for k, v in ops.draw_color_jitter(
            gen, B, 0.4, 0.4, 0.4, 0.1, p=0.8).items()})
        return d

    def apply(self, x: torch.Tensor, d: Draws) -> torch.Tensor:
        x = ops.hflip(ops.to_float(x), d["flip"])
        x = ops.color_jitter(x, {k[3:]: v for k, v in d.items()
                                 if k.startswith("cj_")})
        x = ops.resize(x, (self.size, self.size))
        return ops.normalize(x, self.mean, self.std)


def supcon_train_transform(size: int = 224, mean=ops.IMAGENET_MEAN,
                           std=ops.IMAGENET_STD) -> MultiViewTransform:
    """SupCon's two views (``hairci/aug/pipelines.py:supcon_train_transform``);
    the recipe passes the CIFAR-100 mean and std."""
    v = SupConView(size, tuple(mean), tuple(std))
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


def draw_negative(gen: torch.Generator, B: int) -> Draws:
    """The draws of ``negative_transform``: the flip, then a colour jitter
    of 0.1 / 0.1 / 0.1 / 0.02 applied to every image."""
    d: Draws = {"flip": ops.draw_flags(gen, B, 0.5)}
    d.update({f"cj_{k}": v for k, v in ops.draw_color_jitter(
        gen, B, 0.1, 0.1, 0.1, 0.02, p=1.0).items()})
    return d


def negative_transform(x: torch.Tensor, d: Draws) -> torch.Tensor:
    """The reference's ``negative_transform`` (``transform.py:26-30``, no
    recipe calls it): a horizontal flip with p = 0.5 and a very mild colour
    jitter, on images in [0, 1]."""
    x = ops.hflip(x, d["flip"])
    return ops.color_jitter(x, {k[3:]: v for k, v in d.items()
                                if k.startswith("cj_")})


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
