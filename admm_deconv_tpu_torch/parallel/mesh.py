"""Named meshes of ranks over ``torch.distributed``, and batch sharding helpers.

Counterpart of ``admm_deconv_tpu/parallel/mesh.py``.  A mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` whose axes carry names,
one rank (one process, one device) per position, filled in rank order,
row-major, as the JAX package lays its devices out.  The collectives of a
``"cuda"`` mesh run on NCCL, those of a ``"cpu"`` mesh on gloo; the card
never runs on gloo.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# The collective backend each device type runs on.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _ensure_group(device_type: str) -> None:
    """Make a one-rank process group in a process that has none; check that
    an existing group's backend serves ``device_type``."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {sorted(BACKENDS)}, got {device_type!r}")
    backend = BACKENDS[device_type]
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a 'cuda' mesh needs a CUDA device and none is available")
        torch.cuda.set_device(torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif backend not in dist.get_backend():
        raise RuntimeError(
            f"the process group's backend {dist.get_backend()!r} does not serve "
            f"{device_type!r} tensors; a {device_type!r} mesh runs on {backend}"
        )


def make_mesh(
    axis_sizes: dict[str, int] | None = None, device_type: str = "cuda"
) -> DeviceMesh:
    """Build a named mesh of ranks.

    ``axis_sizes`` maps axis names to sizes, e.g. ``{"data": 2, "tile": 2}``;
    ``None`` puts every rank on a single ``"data"`` axis.  The mesh takes the
    first ``prod(sizes)`` ranks; more than the world holds raises.  In a
    process with no process group (a single-device run) a one-rank group is
    made first, on a ``HashStore``: NCCL for ``"cuda"``, gloo for ``"cpu"``.
    """
    _ensure_group(device_type)
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"data": world}
    names = tuple(axis_sizes)
    sizes = tuple(axis_sizes.values())
    n = math.prod(sizes)
    if n > world:
        raise ValueError(f"mesh needs {n} devices, only {world} available")
    return DeviceMesh(device_type, torch.arange(n).reshape(sizes), mesh_dim_names=names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis`` of ``mesh``."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r}; its axes are {mesh.mesh_dim_names}")
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def shard_batch(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous slice of ``x``'s leading (batch) dim, the
    batch split over ``axis`` as the JAX package shards it."""
    size = axis_size(mesh, axis)
    if x.shape[0] % size:
        raise ValueError(f"batch {x.shape[0]} must divide by the {axis!r} axis size {size}")
    per = x.shape[0] // size
    start = per * mesh.get_local_rank(axis)
    return x[start:start + per]


def replicate(x, mesh: DeviceMesh):
    """The mesh's first rank's value of ``x`` (a tensor, or a list, tuple or
    dict of them) on every rank of the mesh, broadcast in place axis by axis."""
    if isinstance(x, dict):
        return {k: replicate(v, mesh) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(replicate(v, mesh) for v in x)
    for axis in mesh.mesh_dim_names:
        group = mesh.get_group(axis)
        dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    return x
