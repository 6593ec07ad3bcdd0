"""Data parallelism over torch.distributed process groups: the port of the
JAX package's parallel/ (mesh.py's data axis and multihost.py).

JAX runs one SPMD program over a mesh of devices: the batch shards over
the `data` axis, the parameters replicate, and XLA inserts the collectives.
Here one process (a rank) runs a device, a process group takes the mesh's
place, and a rank's contiguous row block of the global batch takes
NamedSharding's.  What the SPMD program made global is made global by hand
(mesh.py): the live-BN statistics, the weighted losses' denominators, the
random draws and the gradient sum.  The `model` axis (tensor and spatial
parallelism) is not ported (ROADMAP A4): MESH.MODEL > 1 and MESH.SPATIAL
raise in models.detector.check_supported.
"""

from faster_rcnn_pytorch_multimodal_tpu_torch.parallel.mesh import (  # noqa: F401
    DataParallel,
    all_reduce_grads_,
    broadcast_parameters_,
    data_parallel,
    data_world_size,
    init_data_parallel,
    local_batch_rows,
    shard_batch,
)
