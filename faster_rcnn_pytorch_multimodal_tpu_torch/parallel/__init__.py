"""Data, tensor and spatial parallelism over torch.distributed process
groups: the port of the JAX package's parallel/ (mesh.py's (data x model)
mesh and multihost.py).

JAX runs one SPMD program over a mesh of devices: the batch shards over
the `data` axis, the RoI tail's channels (and with MESH.SPATIAL the
backbone's rows) over the `model` axis, and XLA inserts the collectives.
Here one process (a rank) runs a device, process groups take the mesh's
place (mesh.py: rank r is (r // m, r % m)), a rank's contiguous row block
of the global batch takes NamedSharding's, and what the SPMD program made
global is made global by hand: the live-BN statistics, the weighted
losses' denominators, the random draws and the gradient sum (mesh.py); the
tail's column- and row-parallel layers (tensor_parallel.py); the
backbone's row slabs and their halo exchange (spatial.py).
"""

from faster_rcnn_pytorch_multimodal_tpu_torch.parallel.mesh import (  # noqa: F401
    DataParallel,
    all_reduce_grads_,
    broadcast_parameters_,
    data_parallel,
    data_world_size,
    init_data_parallel,
    local_batch_rows,
    mesh_shape,
    shard_batch,
)
