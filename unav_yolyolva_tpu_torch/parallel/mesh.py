"""The data-parallel group of a run, the port's counterpart of the JAX
package's parallel/mesh.py.

The JAX program is one global-batch function: the batch is sharded over a
1-D `data` mesh, the state replicated, and XLA inserts the gradient
all-reduce. The port runs one process per card, launched by torchrun

    python -m torch.distributed.run --nproc_per_node N -m <entry point> ...

Each rank holds a contiguous row block of every global batch (`shard_batch`,
the Batcher's `process_index`) and computes its share of the same global
function; the steps sum the shares and the gradients over the ranks
(parallel/collectives.py). The group is NCCL's for CUDA and gloo's for the
CPU, chosen by the device. Without a launcher environment the world is one
process and no group is made: every step then runs exactly as it does
without data parallelism.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device

# what torchrun sets in each process it starts
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class Mesh:
    """The ranks of a run: this process's rank, the world size, its device,
    and the process group (None for one process without a launcher, where
    no collective runs). `owns_group`: make_mesh made the group, and close()
    destroys it."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[Any] = None
    owns_group: bool = False

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that prints, logs and writes."""
        return self.rank == 0

    def close(self) -> None:
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def launcher_env() -> Optional[Dict[str, str]]:
    """torchrun's variables, or None when none is set; a partial set raises
    (a run never falls back to one process silently)."""
    env = {k: os.environ[k] for k in LAUNCHER_ENV if os.environ.get(k)}
    if not env:
        return None
    missing = [k for k in LAUNCHER_ENV if k not in env]
    if missing:
        raise RuntimeError(f"a partial launcher environment: {sorted(env)} set but {missing} "
                           f"not; launch with torchrun, or set none of them")
    return env


def make_mesh(num_devices: int = -1, device=None) -> Mesh:
    """The group of this run (`tpu.num_devices`: -1 takes the world size,
    any other value must equal it). Under torchrun the process group is
    made from its environment, NCCL on the rank's cuda:LOCAL_RANK or gloo
    for device='cpu', unless this process made it already; with no
    launcher environment the world size is 1 and no group is made."""
    env = launcher_env()
    world = int(env["WORLD_SIZE"]) if env else 1
    if num_devices != -1 and num_devices != world:
        raise ValueError(f"tpu.num_devices is {num_devices} but the world size is {world}"
                         + ("" if env else " (no launcher environment: one process)"))
    dev = resolve_device(device)
    if env is None:
        return Mesh(0, 1, dev)
    rank = int(env["RANK"])
    backend = "nccl" if dev.type == "cuda" else "gloo"
    owns = not dist.is_initialized()
    if owns:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                                **({"device_id": dev} if dev.type == "cuda" else {}))
    elif (dist.get_backend(), dist.get_rank(), dist.get_world_size()) != (backend, rank, world):
        raise RuntimeError(f"a process group ({dist.get_backend()}, rank {dist.get_rank()} of "
                           f"{dist.get_world_size()}) exists that is not this run's "
                           f"({backend}, rank {rank} of {world})")
    return Mesh(rank, world, dev, dist.group.WORLD, owns)


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """The rank's contiguous row block [rank * b / n, (rank + 1) * b / n) of
    a global batch of b rows over n ranks: numpy arrays and tensors sliced
    on their first axis (views), other values (video_id lists) passed
    through. The global batch must divide over the ranks."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            b = v.shape[0]
            if b % mesh.world_size:
                raise ValueError(f"shard_batch: {k} has {b} rows, which do not divide over "
                                 f"{mesh.world_size} ranks")
            n = b // mesh.world_size
            v = v[mesh.rank * n:(mesh.rank + 1) * n]
        out[k] = v
    return out


@dataclass(frozen=True)
class RowShard:
    """A random stream drawn for the global batch, of which this rank holds
    a row block: stochastic depth draws one value per row of the GLOBAL
    batch and keeps the rank's rows, so that the ranks together draw what
    one process draws for the whole batch."""

    generator: torch.Generator
    rank: int
    world_size: int


def draws_for(generator: Optional[torch.Generator], mesh: Optional[Mesh]):
    """`generator` as the models take it: a RowShard of it when the world
    has more than one rank."""
    if generator is None or mesh is None or mesh.world_size == 1:
        return generator
    return RowShard(generator, mesh.rank, mesh.world_size)


def uniform_rows(shape: Sequence[int], generator, device, dtype) -> torch.Tensor:
    """U[0, 1) of `shape` in one draw from `generator`; from a RowShard, the
    rank's block of one draw of world_size times shape[0] rows."""
    if isinstance(generator, RowShard):
        n = shape[0]
        u = torch.rand((n * generator.world_size,) + tuple(shape[1:]),
                       generator=generator.generator, device=device, dtype=dtype)
        return u[generator.rank * n:(generator.rank + 1) * n]
    return torch.rand(tuple(shape), generator=generator, device=device, dtype=dtype)
