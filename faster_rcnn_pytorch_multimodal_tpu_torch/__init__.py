"""PyTorch / CUDA port of faster_rcnn_pytorch_multimodal_tpu for one NVIDIA H100.

The JAX package `faster_rcnn_pytorch_multimodal_tpu` is the frozen reference;
this package mirrors its layout (ops/, models/, training/, utils/) and is
checked against it numerically.  It imports torch and never jax: from the JAX package it uses
only the jax-free modules (config, data, evaluation.eval_utils,
utils.convert).

Ported so far: the image C4 serving path (res50/101/152 backbone, RPN,
proposals, RoI align, layer4 tail, predictors, final filtering) and its
training step (anchor and proposal targets, losses, the SGD chain, a minimal
train loop), with hand-written CUDA kernels for NMS and RoI align (forward
and feature gradient) under csrc/, built at first use (ops/_build.py).
"""

__version__ = "0.1.0"
