#!/usr/bin/env python
"""Plot the Bayesian cross-entropy loss surface vs predicted class variance
(the port of tools/cls_uncertainty_vis.py: loss-curve sanity plots for the
aleatoric classification loss), through the port's ops.losses.

One set of num_sample standard normals (a generator seeded 0; JAX's tool
draws them from PRNGKey(0)) distorts every point of the curves, as JAX's
tool reuses its key.  Runs on the CPU: matplotlib is imported at the call.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

MARGINS = np.linspace(-4, 4, 9)  # logit margin of the true class
SIGMAS = np.linspace(0.01, 4.0, 60)


def loss_curves(num_sample: int, normals=None) -> np.ndarray:
    """(len(MARGINS), len(SIGMAS)) Bayesian cross-entropies of logits
    [margin, 0] with target 0 and both logits' variance sigma^2; `normals`
    (num_sample, 1, 2), else drawn from a generator seeded 0."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.losses import bayesian_cross_entropy

    if normals is None:
        normals = torch.randn((num_sample, 1, 2), generator=torch.Generator().manual_seed(0))
    normals = torch.as_tensor(normals, dtype=torch.float32)
    out = np.zeros((len(MARGINS), len(SIGMAS)))
    for i, m in enumerate(MARGINS):
        for j, s in enumerate(SIGMAS):
            logits = torch.tensor([[m, 0.0]], dtype=torch.float32)
            var = torch.full((1, 2), s ** 2, dtype=torch.float32)
            loss, _ = bayesian_cross_entropy(logits, var, torch.tensor([0]), normals)
            out[i, j] = float(loss)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="cls_uncertainty_vis.png", type=str)
    p.add_argument("--num_sample", default=200, type=int)
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    curves = loss_curves(args.num_sample)
    fig, ax = plt.subplots(figsize=(7, 5))
    for m, losses in zip(MARGINS, curves):
        ax.plot(SIGMAS, losses, label=f"margin {m:+.1f}")
    ax.set_xlabel("predicted logit std (sqrt aleatoric variance)")
    ax.set_ylabel("bayesian cross-entropy")
    ax.set_title("Aleatoric CE: variance attenuates confident mistakes")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out}")
    return curves


if __name__ == "__main__":
    main()
