"""Plain building blocks of the references: float32 convolutions and
products whose inputs can be rounded to a lower precision (the control),
BatchNorm and LayerNorm written out, and activation checkpointing.

``Precision("f32")`` computes in float32 with TF32 off (the caller sets
``torch.backends.*.allow_tf32 = False``). ``Precision("fp8")`` is the
control one step below bf16: as a bf16 program keeps its products' inputs
and outputs and its activations in bf16, it rounds them to float8 e4m3
(both inputs and the output of every convolution and product, each
normalisation's output, each block's output), and their gradients in the
backward pass to float8 e5m2, each with one scale a tensor (its largest
magnitude to the format's largest), and computes in float32 between the
roundings.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.q: Callable[[torch.Tensor], torch.Tensor] = (
            _fp8 if name == "fp8" else (lambda t: t))

    def conv(self, x, w, b=None, stride=1, padding=0):
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride, padding))

    def linear(self, x, w, b=None):
        return self.q(F.linear(self.q(x), self.q(w), b))

    def matmul(self, a, b):
        return self.q(torch.matmul(self.q(a), self.q(b)))

    def act(self, x):
        """An activation as the program stores it between operations."""
        return self.q(x)


def batch_norm(x: torch.Tensor, p: Params, name: str, train: bool,
               momentum: float = 0.9, eps: float = 1e-5
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """BatchNorm over every axis but the channel one (axis 1), with the
    biased variance; returns the output and the new running statistics
    (``momentum * old + (1 - momentum) * batch``, the flax convention),
    which are the old ones in eval mode."""
    rm, rv = p[name + ".running_mean"], p[name + ".running_var"]
    dims = (0,) + tuple(range(2, x.dim()))
    if train:
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        stats = (momentum * rm + (1 - momentum) * mean.detach(),
                 momentum * rv + (1 - momentum) * var.detach())
    else:
        mean, var = rm, rv
        stats = (rm, rv)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = ((x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
         * p[name + ".weight"].reshape(shape)
         + p[name + ".bias"].reshape(shape))
    return y, stats


def layer_norm(x: torch.Tensor, p: Params, name: str,
               eps: float = 1e-6) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], eps)


def maybe_checkpoint(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass when
    a gradient is being taken (the reference's memory at the cell's
    batch)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)
