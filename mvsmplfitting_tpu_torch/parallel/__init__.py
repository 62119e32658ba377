"""Parallel layer: frame batches, meshes of ranks, sharded solvers (port
of `parallel/`).

* `frames` mesh axis: independent frame fits split over ranks, with no
  communication until the results are gathered;
* `cameras` mesh axis: one fit's per-view residual blocks on different
  ranks, the Gauss-Newton normal equations of the shared body
  parameters assembled by an all_reduce over the axis;
* a mesh is a `torch.distributed` world (`init_distributed`): NCCL
  across cards, gloo on the CPU or for several ranks on one card;
* data parallelism (`data_parallel`): the training step on the global
  batch, each rank on its block of rows (`batch_rows`), with sums over
  the ranks (`global_sum`, `all_reduce_grads`).
"""

from .mesh import MeshLayout, frames_slice, make_mesh
from .batched import BatchedFitInputs, batched_fit_frames
from .camera_shard import camera_sharded_fit, sharded_triangulate
from .schur import schur_sequence_fit
from .distributed import (global_mesh, init_distributed,
                          process_local_batch_slice)
from .data_parallel import (COMM, all_reduce_grads, batch_rows,
                            block_rows, broadcast_object, broadcast_state,
                            global_sum, init_data_parallel)
