"""PyTorch / CUDA port of faster_rcnn_pytorch_multimodal_tpu for one NVIDIA H100.

The JAX package `faster_rcnn_pytorch_multimodal_tpu` is the frozen reference;
this package mirrors its layout (ops/, models/, training/, data/,
evaluation/, utils/) and is checked against it numerically.  It imports
torch, never jax, and nothing of the JAX package: what it needs of the JAX
package's framework-neutral modules (config, the synthetic dataset and the
batch loader, the evaluation, the weight-key mapping, the CLIs' flags) it
keeps as its own copies (config.py, data/, evaluation/, utils/convert.py,
cli.py).

Ported so far: the image C4 serving path (res50/101/152 backbone, RPN,
proposals, RoI align, layer4 tail, predictors, final filtering), its
training step (anchor and proposal targets, losses, the SGD chain, a minimal
train loop), and the LiDAR BEV C4 serving path (the voxelizer, 3D anchors,
7-DoF decode, the footprint NMS filter), with hand-written CUDA kernels for
NMS, RoI align (forward and feature gradient) and the BEV voxelizer under
csrc/, built at first use (ops/_build.py).
"""

__version__ = "0.1.0"
