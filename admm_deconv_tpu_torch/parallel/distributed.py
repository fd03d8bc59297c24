"""Multi-process initialisation and batch helpers over ``torch.distributed``.

Counterpart of ``admm_deconv_tpu/parallel/distributed.py``: one process
per device joins one process group (NCCL on the card, gloo for the CPU),
and meshes (``parallel/mesh.py``) span its ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from admm_deconv_tpu_torch.parallel.mesh import BACKENDS

# torch 2.13 names all_gather_into_tensor all_gather_single; both take
# (output, input, group) and concatenate the ranks' inputs along dim 0.
all_gather_cat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device_type: str = "cuda",
) -> None:
    """Join the process group: NCCL for ``"cuda"``, gloo for ``"cpu"``.

    ``coordinator_address`` is rank 0's ``host:port``; with it ``None`` the
    address, world size and rank come from torch's ``env://`` variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  On the card
    each process takes device ``rank % device_count`` (one process per card
    of a host).  Call once per process, before any collective.
    """
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {sorted(BACKENDS)}, got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' process group needs a CUDA device and none is available")
    dist.init_process_group(
        BACKENDS[device_type],
        init_method=None if coordinator_address is None else f"tcp://{coordinator_address}",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def _world() -> tuple[int, int]:
    """(process count, this process's index); (1, 0) with no process group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def is_multi_host() -> bool:
    return _world()[0] > 1


def local_batch_slice(global_batch: int) -> slice:
    """This process's contiguous shard of a globally-sharded batch axis."""
    count, index = _world()
    per = global_batch // count
    if per * count != global_batch:
        raise ValueError(
            f"global batch {global_batch} must divide process count {count}"
        )
    start = per * index
    return slice(start, start + per)


def assemble_global_batch(local: torch.Tensor) -> torch.Tensor:
    """The global batch on every rank: the ranks' shards concatenated along
    dim 0 in rank order, by one all-gather.  With no process group the
    local shard is the batch."""
    if not dist.is_initialized():
        return local
    out = local.new_empty((dist.get_world_size() * local.shape[0], *local.shape[1:]))
    all_gather_cat(out, local.contiguous())
    return out
