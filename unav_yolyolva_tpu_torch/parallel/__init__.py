from .collectives import GradSum, all_reduce_sum, broadcast, gather_rows, sharded, sum_losses
from .mesh import Mesh, RowShard, draws_for, launcher_env, make_mesh, shard_batch
from .sync import barrier

__all__ = ["GradSum", "Mesh", "RowShard", "all_reduce_sum", "barrier", "broadcast",
           "draws_for", "gather_rows", "launcher_env", "make_mesh", "shard_batch", "sharded",
           "sum_losses"]
