"""Mesh conventions (port of ``hairci/parallel/mesh.py``).

The JAX package lays its devices out as one 2-D ``(data, model)`` mesh: the
batch is sharded over ``data`` and the face heads' class rows over
``model``. Here a device is a process (one a card), and the mesh is a
``torch.distributed`` ``DeviceMesh`` over the process group's ranks with
dims ``("data", "model")``: rank ``i`` sits at ``(i // n_model, i %
n_model)``. Without a process group the world is one rank and the mesh is
``1 x 1`` with no ``DeviceMesh`` behind it.

A sharding says which mesh axis splits which dim of an array, as a JAX
``PartitionSpec`` does; ``Sharding.local`` is this rank's block of a host
array (each process holds the whole host batch, as each JAX host does
before ``device_put``). ``shard_batch`` gives this rank's rows of a batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch.distributed as dist

from hairci_torch.parallel import collectives

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A ``(data, model)`` grid of ranks. ``shape`` maps each axis to its
    size, as a JAX mesh's does."""

    def __init__(self, n_data: int, n_model: int, device_mesh=None):
        self.shape: Dict[str, int] = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
        self.device_mesh = device_mesh

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of the ranks along ``axis`` that share this
        rank's other coordinate (None without a process group)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)


def create_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """Build the canonical (data, model) mesh over the process group.

    ``n_data`` defaults to ``world // n_model``. Raises, as JAX does, when
    the world does not divide by ``n_model`` or holds fewer ranks than the
    mesh. Unlike JAX's, the mesh must also hold every rank: a process that
    owns a card and sits outside the mesh would have no part of the step.
    """
    world = dist.get_world_size() if collectives.active() else 1
    if n_data is None:
        if world % n_model:
            raise ValueError(
                f"device count {world} not divisible by n_model={n_model}")
        n_data = world // n_model
    n = n_data * n_model
    if n > world:
        raise ValueError(
            f"requested {n_data}x{n_model} mesh but only {world} devices")
    if n < world:
        raise ValueError(
            f"requested {n_data}x{n_model} mesh over {world} processes: the "
            "mesh must hold every process")
    if not collectives.active():
        return Mesh(1, 1)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(n_data, n_model, init_device_mesh(
        device_type, (n_data, n_model),
        mesh_dim_names=(DATA_AXIS, MODEL_AXIS)))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Per dim of an array, the mesh axis that splits it (or None), as a
    ``PartitionSpec``; dims past ``spec`` are replicated."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def local(self, x):
        """This rank's block of ``x`` (a tensor or numpy array): equal
        contiguous blocks along each split dim, in mesh order."""
        index = []
        for dim, axis in enumerate(self.spec):
            if axis is None:
                index.append(slice(None))
                continue
            n = self.mesh.shape[axis]
            if x.shape[dim] % n:
                raise ValueError(
                    f"dim {dim} of size {x.shape[dim]} does not split over "
                    f"the {n} ranks of mesh axis {axis!r}")
            per = x.shape[dim] // n
            lo = self.mesh.coordinate(axis) * per
            index.append(slice(lo, lo + per))
        return x[tuple(index)]


def batch_sharding(mesh: Mesh, ndim: int = 4) -> Sharding:
    """Shard the leading (batch) dim over ``data``; replicate the rest."""
    return Sharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def model_sharding(mesh: Mesh, axis: int, ndim: int) -> Sharding:
    """Shard dimension ``axis`` of an ``ndim`` array over ``model``."""
    spec = [None] * ndim
    spec[axis] = MODEL_AXIS
    return Sharding(mesh, tuple(spec))


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of a host batch (a pytree of dicts, lists and
    tuples over tensors or arrays), split over the data axis."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return batch_sharding(mesh, max(batch.ndim, 1)).local(batch)


def local_mesh_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())
