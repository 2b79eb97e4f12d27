"""The collectives of the data-parallel global function, and nothing more:
a row gather with a gradient (the contrastive loss's global batch), a row
gather without one (the detections), sum all-reduces of scalars and of the
flat gradient buffer (GradSum), and a broadcast from rank 0 (a folder
name, a decision). Each is the identity without a group (GradSum needs
one); with a group it runs at every world size, one rank included, where a
sum of one keeps the bits.

bool tensors travel as uint8 (gloo mishandles bool). gloo has no
reduce-scatter: the gather's backward all-reduces and takes the rank's
rows."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh


def sharded(mesh: Optional[Mesh]) -> bool:
    """Whether collectives run: there is a process group."""
    return mesh is not None and mesh.group is not None


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    """All ranks' rows in rank order; the backward sums the cotangent over
    the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        dist.all_reduce(g, group=mesh.group)
        n = g.shape[0] // mesh.world_size
        return g[mesh.rank * n:(mesh.rank + 1) * n], None


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global batch's rows of a per-rank tensor (every rank's, in rank
    order), differentiable: the gradient of each rank's rows is summed over
    the ranks' losses."""
    if not sharded(mesh):
        return x
    if x.dtype == torch.bool:
        return _gather(x.to(torch.uint8), mesh).bool()
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(x, mesh)
    return _gather(x, mesh)


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum over the ranks of a tensor that needs no gradient (a new
    tensor; x itself without a group)."""
    if not sharded(mesh):
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def sum_losses(losses: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The detached loss scalars, each summed over the ranks in one
    all-reduce (the ranks' shares of a loss add up to the global loss);
    num_pos is global already (compute_losses sums it) and passes through."""
    out = {k: v.detach() for k, v in losses.items()}
    if not sharded(mesh):
        return out
    keys = [k for k in out if k != "num_pos"]
    summed = all_reduce_sum(torch.stack([out[k].float() for k in keys]), mesh)
    out.update({k: summed[i] for i, k in enumerate(keys)})
    return out


class GradSum:
    """Sums the gradients of `params` over the ranks of `mesh` in one
    all-reduce of one flat fp32 buffer, allocated once: each call copies
    the grads into the buffer (a parameter that backward left without one
    gets a zero there), all-reduces it, and makes each parameter's grad its
    view of the buffer (the step's shares' gradients add up to the global
    batch's). The views replace the grads, so no copy comes back; the next
    backward assigns new grads (the optimizer's zero_grad drops them)."""

    def __init__(self, params, mesh: Mesh):
        if not sharded(mesh):
            raise ValueError("GradSum: the mesh has no process group")
        self.params, self.mesh = list(params), mesh
        if any(p.dtype != torch.float32 for p in self.params):
            raise TypeError("GradSum: the parameters must be float32")
        self.flat = torch.empty(sum(p.numel() for p in self.params),
                                device=self.params[0].device, dtype=torch.float32)
        self.views = [v.view_as(p) for p, v in zip(
            self.params, self.flat.split([p.numel() for p in self.params]))]

    def __call__(self) -> None:
        have = [(v, p.grad) for v, p in zip(self.views, self.params) if p.grad is not None]
        torch._foreach_copy_([v for v, _ in have], [g for _, g in have])
        if len(have) < len(self.params):
            torch._foreach_zero_([v for v, p in zip(self.views, self.params) if p.grad is None])
        dist.all_reduce(self.flat, group=self.mesh.group)
        for p, v in zip(self.params, self.views):
            p.grad = v


def broadcast(obj: Any, mesh: Optional[Mesh]) -> Any:
    """Rank 0's value of a picklable object, on every rank."""
    if not sharded(mesh):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group,
                               device=mesh.device if mesh.device.type == "cuda" else None)
    return box[0]
