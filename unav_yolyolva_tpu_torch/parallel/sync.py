"""Cross-rank synchronization, the port's counterpart of the JAX package's
parallel/sync.py: rank 0 writes a file (a checkpoint, model_best) that the
other ranks read next, and they wait for it here."""

from __future__ import annotations

import datetime
from typing import Optional

import torch.distributed as dist

from .mesh import Mesh


def barrier(name: str, mesh: Optional[Mesh]) -> None:
    """Block until every rank of `mesh` reaches the barrier `name`. A no-op
    at world size 1 (or without a mesh)."""
    if mesh is None or mesh.world_size == 1:
        return
    try:
        if mesh.device.type == "cuda":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            # names the rank that has not come after 10 minutes (one that died)
            dist.monitored_barrier(group=mesh.group, timeout=datetime.timedelta(seconds=600))
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r} (rank {mesh.rank} of {mesh.world_size}): {e}"
                           ) from e
