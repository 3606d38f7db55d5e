"""ResNet backbones (port of ``hairci/models/resnet.py``).

torchvision names and layout (``conv1``, ``bn1``, ``layer{1-4}.{j}.conv{i}``,
``downsample.{0,1}``), the key set of
``hairci/retrieval/torch_import.py:export_resnet``. As in the JAX package:
symmetric padding, the stride on the bottleneck's 3x3 conv, the last BN scale
of each block initialised to zero, the imagenet (7x7/2 + max pool) and cifar
(3x3/1) stems, compute in ``dtype`` with f32 params, and features pooled in
f32 then rounded to ``dtype``. ``ResNetFeatures`` (``build_resnet(...,
with_spatial=True)``, DenseCL's trunk) returns ``(pooled, spatial)``: the
last stage's map as NHWC f32 and its f32 mean, not rounded.

A block's BatchNorms take its ReLUs, and its last one the residual add
before the ReLU (``models.norm.BatchNorm``'s ``residual`` and ``relu``): one
hand-written pass on a card, the plain ops' twin on the CPU.

The public boundary is NHWC, as in JAX. Inside, the convs run on
``channels_last`` NCHW tensors: the boundary's NHWC becomes a free
``permute``, and the BatchNorm's ``(N*H*W, C)`` view stays contiguous.

Which convs go to the hand-written kernel: a ``Conv2d`` that is 3x3, stride
1, padding 1, 64 -> 64 channels goes through ``ops.conv3x3`` whenever grad
mode is off (``torch.is_grad_enabled()`` is false, as under
``torch.no_grad()`` in feature extraction and in the EMA teacher's forward):
the CUDA kernel on a card, its plain twin on the CPU. In ResNet-50 these are
layer1's three ``conv2``; in ResNet-18/34 layer1's four/six convs. With grad
mode on the same conv runs through cuDNN: the kernel has no backward (the
JAX package has none for its TPU counterpart either). Every other conv is
cuDNN's. Such a conv keeps its weights in the kernel's layout
(``ops.conv3x3.pack_weights``) between calls and packs them again when the
weight has changed: in-place updates (the optimizer's, the EMA teacher's,
``load_state_dict``) bump ``weight._version``, a move or cast changes the
pointer, device or type. The cache is no parameter or buffer, so the state
dict does not see it.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hairci_torch.models.norm import BatchNorm
from hairci_torch.ops.conv3x3 import conv3x3, pack_weights


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default kernel init: truncated normal (at 2 std) of variance
    1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


class Conv2d(nn.Conv2d):
    """Bias-free conv computing in ``dtype`` (flax ``nn.Conv(dtype=...)``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         bias=False)
        self.dtype = dtype
        # the shape of the hand-written kernel (see the module docstring)
        self.to_kernel = (k, stride, padding, cin, cout) == (3, 1, 1, 64, 64)
        self._packed_key = None
        self._packed = self._packed_of = None
        with torch.no_grad():
            lecun_normal_(self.weight, cin * k * k)

    def packed_weight(self) -> torch.Tensor:
        """The weight in the conv3x3 kernel's layout, packed anew whenever
        the weight's version, storage, device or the compute type changed
        (a write through ``weight.data`` changes none of them and would be
        missed: update the parameter itself, under ``torch.no_grad()``)."""
        w = self.weight
        key = (w._version, w.data_ptr(), self.dtype, w.device)
        if key != self._packed_key:
            self._packed = pack_weights(w, self.dtype)
            # the key holds the storage it names: while it is cached no
            # other tensor can come to lie at that address
            self._packed_key = key
            self._packed_of = w.detach()
        return self._packed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.to_kernel and not torch.is_grad_enabled():
            return conv3x3(x.to(self.dtype), self.weight,
                           packed=self.packed_weight())
        return self._conv_forward(x.to(self.dtype),
                                  self.weight.to(self.dtype), None)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, dtype):
        super().__init__()
        self.conv1 = Conv2d(cin, filters, 3, stride, 1, dtype)
        self.bn1 = BatchNorm(filters, dtype=dtype)
        self.conv2 = Conv2d(filters, filters, 3, 1, 1, dtype)
        self.bn2 = BatchNorm(filters, dtype=dtype, zero_init=True)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(
                Conv2d(cin, filters, 1, stride, 0, dtype),
                BatchNorm(filters, dtype=dtype))

    def forward(self, x):
        y = self.bn1(self.conv1(x), relu=True)
        y = self.conv2(y)
        residual = x if self.downsample is None else self.downsample(x)
        return self.bn2(y, residual=residual, relu=True)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, dtype):
        super().__init__()
        out = filters * 4
        self.conv1 = Conv2d(cin, filters, 1, 1, 0, dtype)
        self.bn1 = BatchNorm(filters, dtype=dtype)
        self.conv2 = Conv2d(filters, filters, 3, stride, 1, dtype)
        self.bn2 = BatchNorm(filters, dtype=dtype)
        self.conv3 = Conv2d(filters, out, 1, 1, 0, dtype)
        self.bn3 = BatchNorm(out, dtype=dtype, zero_init=True)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(
                Conv2d(cin, out, 1, stride, 0, dtype),
                BatchNorm(out, dtype=dtype))

    def forward(self, x):
        y = self.bn1(self.conv1(x), relu=True)
        y = self.bn2(self.conv2(y), relu=True)
        y = self.conv3(y)
        residual = x if self.downsample is None else self.downsample(x)
        return self.bn3(y, residual=residual, relu=True)


class ResNet(nn.Module):
    """ResNet trunk; ``forward`` maps (B, H, W, 3) to pooled (B, D) f32."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_filters: int = 64, stem: str = "imagenet",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if stem not in ("imagenet", "cifar"):
            raise ValueError(f"unknown stem {stem!r}")
        self.stem = stem
        self.dtype = dtype
        k, s, p = (7, 2, 3) if stem == "imagenet" else (3, 1, 1)
        self.conv1 = Conv2d(3, num_filters, k, s, p, dtype)
        self.bn1 = BatchNorm(num_filters, dtype=dtype)
        cin = num_filters
        for i, n_blocks in enumerate(stage_sizes):
            filters = num_filters * 2 ** i
            blocks: List[nn.Module] = []
            for j in range(n_blocks):
                blocks.append(block_cls(cin, filters,
                                        2 if i > 0 and j == 0 else 1, dtype))
                cin = filters * block_cls.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.num_features = cin

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> the last stage's map, ``channels_last`` NCHW in
        ``dtype``."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = self.bn1(self.conv1(x), relu=True)
        if self.stem == "imagenet":
            x = F.max_pool2d(x, 3, 2, 1)
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.trunk(x)
        return x.mean(dim=(2, 3), dtype=torch.float32).to(self.dtype).float()


class ResNetFeatures(ResNet):
    """The trunk returning ``(pooled, spatial)`` for dense heads
    (``hairci/models/resnet.py:ResNetFeatures``): ``spatial`` is the last
    map as NHWC (B, H, W, C) f32 (a ``channels_last`` map permuted is
    contiguous, so its ``(B, H*W, C)`` view follows JAX's row-major (h, w)
    order), ``pooled`` its f32 mean over H and W, not rounded to
    ``dtype`` as ``ResNet.forward``'s is."""

    def forward(self, x: torch.Tensor):  # type: ignore[override]
        spatial = self.trunk(x).permute(0, 2, 3, 1).float()
        return spatial.mean(dim=(1, 2)), spatial


_STAGES = {
    "resnet18": ([2, 2, 2, 2], BasicBlock),
    "resnet34": ([3, 4, 6, 3], BasicBlock),
    "resnet50": ([3, 4, 6, 3], BottleneckBlock),
    "resnet101": ([3, 4, 23, 3], BottleneckBlock),
}

# feature widths by name (``hairci/models/resnet.py:MODEL_DICT``)
MODEL_DICT = {"resnet18": 512, "resnet34": 512, "resnet50": 2048,
              "resnet101": 2048}


def build_resnet(name: str, stem: str = "imagenet",
                 dtype: torch.dtype = torch.float32,
                 with_spatial: bool = False) -> ResNet:
    if name not in _STAGES:
        raise ValueError(f"unknown resnet {name!r}; choices: {sorted(_STAGES)}")
    stages, block = _STAGES[name]
    cls = ResNetFeatures if with_spatial else ResNet
    return cls(stages, block, stem=stem, dtype=dtype)
