"""BatchNorm in the flax convention (port of ``hairci/models/norm.py``).

Every reduction and the normalise run on a 2-D ``(N*H*W, C)`` view of a
channel-last input; for a ``channels_last`` NCHW tensor that view is free.
Train mode takes the f32 sum and sum of squares from ``ops.bn_stats`` (the
CUDA kernel on a card, its twin on the CPU) and forms mean = E[x] and the
*biased* var = E[x^2] - E[x]^2. The running stats follow flax:
``m * old + (1 - m) * new`` with m = 0.9 and the biased var -- the stock
``nn.BatchNorm2d`` keeps the unbiased var with momentum 0.1. There is no
``num_batches_tracked`` buffer: the JAX state has none to convert.

Under data parallelism (a process group, ``parallel.collectives``) the
statistics are the global batch's, as under JAX's sharding: each rank's
kernel sums its own rows, and one differentiable all-reduce adds the sums,
the sums of squares and the row counts of every rank before the mean and
var are formed, so the running stats agree on every rank.
``nn.SyncBatchNorm`` would keep the unbiased var at momentum 0.1.

The non-centred form (the ResNet trunk's) runs as
``ops.bn_apply.BatchNormApply``: one hand-written pass that normalises and,
where the block asks (``residual``, ``relu``), adds the residual and takes
the ReLU, and a two-pass backward; eval mode runs the same apply with the
running statistics. The centred form (the projection heads') stays plain
torch over the bn_stats sums.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hairci_torch.ops.bn_apply import BatchNormApply
from hairci_torch.ops.bn_stats import BNStats
from hairci_torch.parallel import collectives


class BatchNorm(nn.Module):
    """Flax-compatible BatchNorm over the last axis of a 2-D input, or the
    channel axis of a 4-D NCHW input (channels_last keeps it copy-free).

    The output is ``x * w + b`` in f32 with w = scale / sqrt(var + eps) and
    b = bias - mean * w, cast to ``dtype`` (``hairci/models/norm.py``). With
    ``centered`` it is ``(x - mean) * w + bias`` with the var clamped at 0,
    the form of ``flax.linen.BatchNorm``, which the JAX projection head uses:
    on a small batch of similar rows the two differ by far more than f32
    rounding, since x * w - mean * w cancels.
    """

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 zero_init: bool = False, centered: bool = False):
        super().__init__()
        self.centered = centered
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(num_features) if zero_init
                                   else torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                relu: bool = False) -> torch.Tensor:
        """The normalised ``x``; with ``residual`` (x's shape) then
        ``residual + y``, and with ``relu`` then ``relu(.)``: the end of a
        ResNet block, in the non-centred form only."""
        c = self.weight.shape[0]
        nhwc = x.permute(0, 2, 3, 1) if x.dim() == 4 else x
        x2 = nhwc.reshape(-1, c).contiguous()
        if self.centered:
            if residual is not None or relu:
                raise ValueError("BatchNorm: the residual add and the ReLU "
                                 "are fused in the non-centred form only")
            y = self._centered(x2)
        else:
            if residual is not None:
                residual = (residual.permute(0, 2, 3, 1) if residual.dim() == 4
                            else residual).reshape(-1, c).contiguous()
            y = BatchNormApply.apply(
                x2, self.weight, self.bias, residual, self.running_mean,
                self.running_var, self.training, self.momentum, self.eps,
                self.dtype, relu)
        y = y.reshape(nhwc.shape)
        return y.permute(0, 3, 1, 2) if x.dim() == 4 else y

    def _centered(self, x2: torch.Tensor) -> torch.Tensor:
        """``(x - mean) * w + bias`` of an (M, C) input, cast to ``dtype``."""
        if self.training:
            c = self.weight.shape[0]
            s, sq = BNStats.apply(x2)
            # the row count as a device tensor with or without a process
            # group, so that both divide alike (a division by a host scalar
            # may round otherwise on a card)
            n = s.new_full((1,), x2.shape[0])
            if collectives.active():
                tot = collectives.all_reduce_sum(torch.cat([s, sq, n]))
                s, sq, n = tot[:c], tot[c:2 * c], tot[2 * c:].detach()
            mean = s / n
            var = torch.clamp(sq / n - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        w = torch.rsqrt(var + self.eps) * self.weight
        return ((x2.float() - mean) * w + self.bias).to(self.dtype)

    def extra_repr(self) -> str:
        return (f"{self.weight.shape[0]}, momentum={self.momentum}, "
                f"eps={self.eps}, dtype={self.dtype}")
