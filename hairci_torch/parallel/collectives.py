"""Collectives (port of ``hairci/parallel/collectives.py``) on
``torch.distributed``: one process a card, NCCL on cards and gloo on the CPU.

Under JAX the batch is one global array sharded over the ``data`` mesh axis
and XLA inserts every collective. Here each rank holds its rows of the
global batch, and the code that needs the whole batch calls a collective
itself:

  - ``all_gather``: differentiable, concatenated on dim 0 (the reference's
    ``GatherLayer``);
  - ``all_reduce_sum`` / ``all_reduce_mean``: differentiable;
  - ``global_mean``: the mean of a per-row quantity over the global batch;
  - ``all_reduce_mean_``: one coalesced, in-place all-reduce mean of many
    tensors (the gradients, ``train.optim.all_reduce_grads_``);
  - ``gather_from_group`` / ``copy_to_group``: the tensor-parallel pair,
    for ranks that compute the SAME loss (the ``model`` group of a mesh,
    ``models.face_vit.tp_margin_logits``).

They act on the *data group*: the ranks that split the batch (the whole
world, or the ``data`` axis of a mesh with a ``model`` axis: ``set_group``).
With no process group the world is one rank and every collective returns
its input; ``active()`` tells the two apart. ``calls`` counts the
collectives issued, forward and backward, by name.

Gradients. The backward of each collective is its adjoint with respect to
the SUM of every rank's loss: ``all_gather``'s all-reduces the incoming
gradient and keeps this rank's rows, ``all_reduce_sum``'s all-reduces it.
A loss that every rank computes alike from gathered tensors (the replicated
global loss) therefore puts W times its gradient on each rank's own rows,
and the mean of the ranks' parameter gradients that ``all_reduce_mean_``
takes after ``backward()`` divides that W out: it is the global loss's
gradient. A term written as a ``global_mean`` of local rows is replicated
the same way and needs no other care.

The tensor-parallel pair is for the other case: the ranks of a ``model``
group hold the same rows and each computes the same loss from the gathered
shards, so that loss counts once, not once a rank. ``gather_from_group``
gathers in the forward and only slices in the backward (the gradient each
rank holds is already the whole loss's), and ``copy_to_group`` is the
identity whose backward sums the shards' partial gradients over the group.
Both name their group: they never fall back to the data group.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# collectives issued since the last reset, by name (forward and backward)
calls: Dict[str, int] = {"all_gather": 0, "all_reduce": 0}

_group: Optional["dist.ProcessGroup"] = None   # None: the whole world


def active() -> bool:
    """True when a process group is initialised (the data-parallel path)."""
    return dist.is_available() and dist.is_initialized()


def set_group(group: Optional["dist.ProcessGroup"]) -> None:
    """The group the collectives act on by default (None: the world)."""
    global _group
    _group = group


def _g(group):
    return _group if group is None else group


def world(group=None) -> int:
    """Ranks of the data group (1 without a process group)."""
    return dist.get_world_size(_g(group)) if active() else 1


def rank(group=None) -> int:
    """This rank's index in the data group (0 without a process group)."""
    return dist.get_rank(_g(group)) if active() else 0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: Optional[torch.device] = None
                     ) -> Optional[torch.device]:
    """Rendezvous at ``tcp://coordinator_address`` (``host:port`` of rank
    0): NCCL when ``device`` is a card, gloo otherwise. A no-op for at most
    one process, as in JAX. Returns this rank's device: rank i takes
    ``cuda:{i % device_count}``."""
    if num_processes is None or num_processes <= 1:
        return device
    if coordinator_address is None or process_id is None:
        raise ValueError("init_distributed: --coordinator and "
                         "--process_index are required with "
                         f"--num_processes {num_processes}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"init_distributed: process index {process_id} "
                         f"outside [0, {num_processes})")
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            rank=process_id, world_size=num_processes,
                            device_id=device if cuda else None)
    log.info("rank %d of %d on %s", process_id, num_processes,
             device or "cpu")
    return device


def shutdown() -> None:
    """Leave the process group, if any, and forget the data group."""
    set_group(None)
    if active():
        dist.destroy_process_group()


def is_main_process() -> bool:
    return not active() or dist.get_rank() == 0


# ``all_gather_single`` replaces ``all_gather_into_tensor`` in newer torch
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    calls["all_gather"] += 1
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]))
    _gather_into(out, x, group=group)
    return out


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A summed copy of ``x`` (the input is left as it is)."""
    calls["all_reduce"] += 1
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        lo = dist.get_rank(ctx.group) * ctx.rows
        return _reduce(grad, ctx.group)[lo:lo + ctx.rows], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.group), None


class _GatherSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        lo = dist.get_rank(ctx.group) * ctx.rows
        return grad[lo:lo + ctx.rows], None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.group), None


def gather_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank of ``group``'s ``x`` concatenated on dim 0 in group-rank
    order; the backward keeps this rank's rows of the incoming gradient
    and reduces nothing (the tensor-parallel gather: every rank of the
    group computes the same loss). ``x`` itself without a process group."""
    if not active():
        return x
    if group is None:
        raise ValueError("gather_from_group needs its group")
    return _GatherSlice.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; the backward sums the incoming gradient over
    ``group`` (an input that every shard of the group reads). ``x`` itself
    without a process group."""
    if not active():
        return x
    if group is None:
        raise ValueError("copy_to_group needs its group")
    return _CopyToGroup.apply(x, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated on dim 0 in rank order
    (differentiable; ``x`` itself without a process group)."""
    if not active():
        return x
    return _AllGather.apply(x, _g(group))


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` (differentiable)."""
    if not active():
        return x
    return _AllReduceSum.apply(x, _g(group))


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of every rank's ``x`` (differentiable)."""
    if not active():
        return x
    return all_reduce_sum(x, group) / world(group)


def global_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x.mean()`` over the rows of every rank: the mean of the local
    means, since every rank holds the same number of rows."""
    return all_reduce_mean(x.mean(), group)


@torch.no_grad()
def all_reduce_mean_(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the ranks, in place, with one
    all-reduce per dtype and device (the tensors flattened into one
    buffer). Every rank ends with the same bits."""
    if not active():
        return
    group = _g(group)
    n = dist.get_world_size(group)
    buckets: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        calls["all_reduce"] += 1
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def shard_for_host(n: int, process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> np.ndarray:
    """Contiguous index shard of a length-n dataset for one process
    (``NodeDistributedSampler``'s node-aware sharding): ceil(n / count)
    indices a process, the last shard cut short."""
    pi = (dist.get_rank() if active() else 0) if process_index is None \
        else process_index
    pc = (dist.get_world_size() if active() else 1) if process_count is None \
        else process_count
    per = (n + pc - 1) // pc
    start = pi * per
    return np.arange(start, min(start + per, n))
