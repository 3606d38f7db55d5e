"""Plain ResNet (He et al. 2015, arXiv:1512.03385) with the SHAM
projection head, in float32, on a dict of tensors named as torchvision
names them (``conv1``, ``bn1``, ``layer{i}.{j}.conv{k}``,
``downsample.{0,1}``).

Departures from the paper, as the configuration states them: BatchNorm
keeps biased running variances at momentum 0.9; the last BN scale of each
block starts at zero; the pooled features feed a projection head Linear
(no bias) -> BN -> ReLU -> Linear (no bias) -> BN.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from harness.data import Leaf, fan_in_leaf
from reference.nn import Params, Precision, batch_norm, maybe_checkpoint

EXPANSION = {"basic": 1, "bottleneck": 4}


def _bn_leaves(name: str, c: int, scale: str = "ones") -> List[Leaf]:
    return [Leaf(name + ".weight", (c,), scale),
            Leaf(name + ".bias", (c,), "zeros"),
            Leaf(name + ".running_mean", (c,), "zeros"),
            Leaf(name + ".running_var", (c,), "ones")]


def _blocks(arch) -> List[Tuple[str, int, int, int]]:
    """(name, cin, filters, stride) of every block."""
    out, cin, width = [], arch["width"], arch["width"]
    for i, n in enumerate(arch["stages"]):
        filters = width * 2 ** i
        for j in range(n):
            out.append((f"layer{i + 1}.{j}", cin, filters,
                        2 if i > 0 and j == 0 else 1))
            cin = filters * EXPANSION[arch["block"]]
    return out


def num_features(arch) -> int:
    return arch["width"] * 2 ** (len(arch["stages"]) - 1) \
        * EXPANSION[arch["block"]]


def spec(arch, prefix: str = "backbone.") -> List[Leaf]:
    """Every leaf of the trunk, with its initialiser."""
    w = arch["width"]
    k = 7 if arch["stem"] == "imagenet" else 3
    leaves = [fan_in_leaf(prefix + "conv1.weight", (w, 3, k, k))]
    leaves += _bn_leaves(prefix + "bn1", w)
    exp = EXPANSION[arch["block"]]
    for name, cin, f, stride in _blocks(arch):
        n = prefix + name
        if arch["block"] == "bottleneck":
            shapes = [(f, cin, 1, 1), (f, f, 3, 3), (f * 4, f, 1, 1)]
        else:
            shapes = [(f, cin, 3, 3), (f, f, 3, 3)]
        for i, shape in enumerate(shapes, 1):
            leaves.append(fan_in_leaf(f"{n}.conv{i}.weight", shape))
            # the last BN scale of each block starts at zero, as the
            # configuration's ResNet (and Goyal et al. 2017) starts it
            leaves += _bn_leaves(f"{n}.bn{i}", shape[0],
                                 "zeros" if i == len(shapes) else "ones")
        if stride != 1 or cin != f * exp:
            leaves.append(fan_in_leaf(f"{n}.downsample.0.weight",
                                      (f * exp, cin, 1, 1)))
            leaves += _bn_leaves(f"{n}.downsample.1", f * exp)
    return leaves


def _block(P: Precision, p: Params, n: str, block: str, stride: int,
           train: bool, x: torch.Tensor):
    stats = {}

    def bn(y, name):
        y, stats[name] = batch_norm(y, p, name, train)
        return P.act(y)

    if block == "bottleneck":
        y = F.relu(bn(P.conv(x, p[n + ".conv1.weight"]), n + ".bn1"))
        y = F.relu(bn(P.conv(y, p[n + ".conv2.weight"], stride=stride,
                             padding=1), n + ".bn2"))
        y = bn(P.conv(y, p[n + ".conv3.weight"]), n + ".bn3")
    else:
        y = F.relu(bn(P.conv(x, p[n + ".conv1.weight"], stride=stride,
                             padding=1), n + ".bn1"))
        y = bn(P.conv(y, p[n + ".conv2.weight"], padding=1), n + ".bn2")
    if n + ".downsample.0.weight" in p:
        r = bn(P.conv(x, p[n + ".downsample.0.weight"], stride=stride),
               n + ".downsample.1")
    else:
        r = x
    names = sorted(stats)
    return (P.act(F.relu(r + y)), *[t for k in names for t in stats[k]]), names


def features(arch, P: Precision, p: Params, x: torch.Tensor, train: bool,
             prefix: str = "backbone.") -> Tuple[torch.Tensor, Params]:
    """(B, H, W, 3) f32 -> pooled (B, D) f32, and the new BN running
    statistics by leaf name (train mode) or none (eval mode)."""
    new: Params = {}

    def collect(out, names):
        for i, k in enumerate(names):
            new[k + ".running_mean"], new[k + ".running_var"] = \
                out[1 + 2 * i], out[2 + 2 * i]
        return out[0]

    def stem(x):
        s = 2 if arch["stem"] == "imagenet" else 1
        y = P.conv(x.permute(0, 3, 1, 2), p[prefix + "conv1.weight"],
                   stride=s, padding=3 if arch["stem"] == "imagenet" else 1)
        y, st = batch_norm(y, p, prefix + "bn1", train)
        y = F.relu(P.act(y))
        if arch["stem"] == "imagenet":
            y = F.max_pool2d(y, 3, 2, 1)
        return y, *st

    out = maybe_checkpoint(stem, x)
    y = collect(out, [prefix + "bn1"])
    for name, _, _, stride in _blocks(arch):
        n = prefix + name
        names: List[str] = []

        def run(t, n=n, stride=stride, names=names):
            res, nm = _block(P, p, n, arch["block"], stride, train, t)
            names[:] = nm
            return res

        out = maybe_checkpoint(run, y)
        y = collect(out, names)
    if not train:
        new = {}
    return y.mean(dim=(2, 3)), new


def head_spec(in_dim: int, hidden: int, out: int,
              prefix: str = "projection_head.layers.") -> List[Leaf]:
    return ([fan_in_leaf(prefix + "0.weight", (hidden, in_dim))]
            + _bn_leaves(prefix + "1", hidden)
            + [fan_in_leaf(prefix + "3.weight", (out, hidden))]
            + _bn_leaves(prefix + "4", out))


def head(P: Precision, p: Params, x: torch.Tensor, train: bool,
         prefix: str = "projection_head.layers."
         ) -> Tuple[torch.Tensor, Params]:
    new: Params = {}
    y = P.linear(x, p[prefix + "0.weight"])
    y, st = batch_norm(y, p, prefix + "1", train)
    new[prefix + "1.running_mean"], new[prefix + "1.running_var"] = st
    y = P.linear(F.relu(P.act(y)), p[prefix + "3.weight"])
    y, st = batch_norm(y, p, prefix + "4", train)
    new[prefix + "4.running_mean"], new[prefix + "4.running_var"] = st
    return P.act(y), (new if train else {})


def forward_flops(arch, img: int) -> Dict[str, float]:
    """Multiply-add FLOPs (2 a multiply-add) of one image's trunk forward:
    every convolution, by layer kind; ``first`` is the stem's convolution,
    whose input takes no gradient."""
    w = arch["width"]
    k, s = (7, 2) if arch["stem"] == "imagenet" else (3, 1)
    h = img // s
    first = 2.0 * 3 * w * k * k * h * h
    if arch["stem"] == "imagenet":
        h //= 2
    total = first
    exp = EXPANSION[arch["block"]]
    for _, cin, f, stride in _blocks(arch):
        ho = h // stride
        if arch["block"] == "bottleneck":
            total += 2.0 * cin * f * h * h              # 1x1
            total += 2.0 * f * f * 9 * ho * ho          # 3x3, strided
            total += 2.0 * f * f * 4 * ho * ho          # 1x1
        else:
            total += 2.0 * cin * f * 9 * ho * ho
            total += 2.0 * f * f * 9 * ho * ho
        if stride != 1 or cin != f * exp:
            total += 2.0 * cin * f * exp * ho * ho
        h = ho
    return {"total": total, "first": first}


def bn_inputs(arch, rows: int, img: int) -> List[Tuple[int, int]]:
    """(elements a channel, channels) of every trunk BN input at ``rows``
    images: the bn_stats kernel reads each once."""
    w = arch["width"]
    s = 2 if arch["stem"] == "imagenet" else 1
    h = img // s
    out = [(rows * h * h, w)]
    if arch["stem"] == "imagenet":
        h //= 2
    exp = EXPANSION[arch["block"]]
    for _, cin, f, stride in _blocks(arch):
        ho = h // stride
        if arch["block"] == "bottleneck":
            out += [(rows * h * h, f), (rows * ho * ho, f),
                    (rows * ho * ho, f * 4)]
        else:
            out += [(rows * ho * ho, f), (rows * ho * ho, f)]
        if stride != 1 or cin != f * exp:
            out.append((rows * ho * ho, f * exp))
        h = ho
    return out
