"""Inputs made from ``--seed``: weights by name, uint8 images, gallery rows.

Everything is drawn on the run's device by a ``torch.Generator`` there, in
a few large calls, and both the program and the reference take the same
numbers: the reference makes them again from the seed, it is not handed
the program's copy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# streams of one seed
WEIGHTS, IMAGES, GALLERY, QUERIES, STEPS, SAMPLE = range(1, 7)


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    state = np.random.SeedSequence([int(seed) % (1 << 63), *tags])
    return int(state.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def generator(seed: int, tags, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    tags = tuple(tags) if isinstance(tags, (tuple, list)) else (tags,)
    return g.manual_seed(sub_seed(seed, *tags))


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One tensor of a model's state by name: ``init`` is ``normal``
    (N(0, 1) times ``scale``), ``ones``, ``zeros`` or ``fixed`` (``value``,
    a numpy array)."""
    name: str
    shape: Tuple[int, ...]
    init: str
    scale: float = 1.0
    value: object = None


def fan_in_leaf(name: str, shape: Sequence[int]) -> Leaf:
    """A weight drawn N(0, 1 / fan_in): the variance lecun-normal keeps."""
    fan_in = int(np.prod(shape[1:]))
    return Leaf(name, tuple(shape), "normal", fan_in ** -0.5)


def make_params(spec: Sequence[Leaf], seed: int, device,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Every leaf of ``spec``, the drawn ones from one ``randn`` call in the
    order of ``spec``."""
    gen = generator(seed, WEIGHTS, device)
    drawn = [leaf for leaf in spec if leaf.init == "normal"]
    total = sum(int(np.prod(leaf.shape)) for leaf in drawn)
    buf = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for leaf in spec:
        n = int(np.prod(leaf.shape))
        if leaf.init == "normal":
            t = buf[at:at + n].reshape(leaf.shape) * leaf.scale
            at += n
        elif leaf.init == "ones":
            t = torch.ones(leaf.shape, device=device)
        elif leaf.init == "zeros":
            t = torch.zeros(leaf.shape, device=device)
        elif leaf.init == "fixed":
            t = torch.as_tensor(np.asarray(leaf.value, np.float32),
                                device=device).reshape(leaf.shape)
        else:
            raise ValueError(f"{leaf.name}: unknown init {leaf.init!r}")
        out[leaf.name] = t.to(dtype)
    return out


def make_images(n: int, size: int, seed: int, tags, device,
                chunk: int = 256) -> torch.Tensor:
    """(n, size, size, 3) uint8 on ``device``: smooth random colour fields
    (an 8 x 8 grid of colours, bilinearly upsampled) with fine noise on
    top, so that images differ at every scale a crop can pick, each at its
    own exposure (a gain in [0.1, 1] and an offset a channel), as photos
    differ."""
    gen = generator(seed, tags, device)
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    for s in range(0, n, chunk):
        b = min(chunk, n - s)
        coarse = torch.rand((b, 3, 8, 8), generator=gen, device=device)
        x = F.interpolate(coarse, size=(size, size), mode="bilinear",
                          align_corners=False)
        x = x + 0.08 * torch.randn((b, 3, size, size), generator=gen,
                                   device=device)
        gain = 0.1 + 0.9 * torch.rand((b, 1, 1, 1), generator=gen,
                                      device=device)
        offset = (1.0 - gain) * torch.rand((b, 3, 1, 1), generator=gen,
                                           device=device)
        x = torch.clamp((x * gain + offset) * 255.0, 0.0, 255.0)
        x = x.round().to(torch.uint8)
        out[s:s + b] = x.permute(0, 2, 3, 1)
    return out


def make_gallery(rows: int, dim: int, seed: int, device) -> torch.Tensor:
    """(rows, dim) f32 unit rows."""
    gen = generator(seed, GALLERY, device)
    g = torch.randn((rows, dim), generator=gen, device=device)
    return g / torch.linalg.vector_norm(g, dim=1, keepdim=True)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator a training step draws its augmentations from."""
    return torch.Generator().manual_seed(sub_seed(seed, STEPS, step))


def sample(seed: int, n: int, k: int, must: Sequence[int] = ()) -> List[int]:
    """``k`` of ``range(n)`` drawn from the seed, sorted, with ``must``
    among them."""
    rng = np.random.default_rng(sub_seed(seed, SAMPLE))
    rest = [i for i in rng.permutation(n).tolist() if i not in set(must)]
    return sorted(set(must) | set(rest[:max(0, k - len(set(must)))]))
