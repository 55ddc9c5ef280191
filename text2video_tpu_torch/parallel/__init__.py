"""The mesh: data parallelism over ``torch.distributed`` (counterpart of
``text2video_tpu/parallel``).

The JAX package runs one controller over a ``jax.sharding.Mesh`` with axes
("data", "model"). Here each card is driven by a process of its own, and the
mesh is a process group: ``make_mesh`` joins (or starts) the group and says
where this process sits on the "data" axis. Functions that take ``mesh=``
run SPMD: every rank of the data group calls them with the same arguments,
works on its share of the leading axis (utterances, frames or clips), and
gets the whole result back. Only global rank 0 writes files.

The processes form a ("data", "model") grid (``make_mesh(n_data, n_model)``).
The serving paths shard over "data" and replicate over "model", as the JAX
package's do. Training also shards the wide conv kernels by output channel
over "model" (``shard_params``, the JAX package's rule) and gathers them
whole once a micro-batch (``model_axis``).
"""

from text2video_tpu_torch.parallel.launch import spawn
from text2video_tpu_torch.parallel.mesh import (
    Mesh,
    barrier,
    gather_rows,
    halo_rows,
    make_mesh,
    mean_ordered,
    param_specs,
    replicate,
    shard_params,
    shard_rows,
)

__all__ = ["Mesh", "make_mesh", "barrier", "shard_rows", "gather_rows",
           "replicate", "halo_rows", "mean_ordered", "param_specs",
           "shard_params", "spawn"]
