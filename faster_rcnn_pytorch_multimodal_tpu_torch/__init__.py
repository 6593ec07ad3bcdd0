"""PyTorch / CUDA port of faster_rcnn_pytorch_multimodal_tpu for one NVIDIA H100.

The JAX package `faster_rcnn_pytorch_multimodal_tpu` is the frozen reference;
this package mirrors its layout (ops/, models/, training/, data/,
evaluation/, utils/) and is checked against it numerically.  It imports
torch, never jax, and nothing of the JAX package: what it needs of the JAX
package's framework-neutral modules (config, the synthetic dataset and the
batch loader, the evaluation, the weight-key mapping, the CLIs' flags) it
keeps as its own copies (config.py, data/, evaluation/, utils/convert.py,
cli.py).

Ported so far: every model path of the JAX package's C4 and FPN image
detectors and its LiDAR BEV C4 detector (res18/34/50/101/152, frozen or
live BN), serving and training, with axis-aligned or rotated NMS and with
uncertainty on the C4 paths; the Solver (snapshots, exact resume, the val
cycle, preload) and the loader (prefetch thread, worker processes, resume
state); the KITTI, Waymo and CADC databases with their augmentation (the
native point-cloud ops of csrc/pc_ops.cpp, built with g++ at first use,
native/pc_ops.py) and their difficulty-aware evaluation; data-parallel
training, one rank a device over torch.distributed (parallel/); the CLIs
tools/*_torch.py.  The device ops are hand-written CUDA kernels under csrc/
(NMS axis-aligned and rotated, RoI align single-level and multiscale with
their feature gradients, the BEV voxelizer), built with nvcc at first use
(ops/_build.py).  ROADMAP.md lists what is left (Queue A).
"""

__version__ = "0.1.0"
