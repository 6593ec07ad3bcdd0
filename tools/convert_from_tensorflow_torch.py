#!/usr/bin/env python
"""Import a tf-faster-rcnn (tf-slim) checkpoint into the PyTorch port: the
port's copy of tools/convert_from_tensorflow.py, over the port's converters
(utils/convert.py tf_slim_{resnet,vgg,mobilenet}_to_torch, then
load_torchvision_resnet or load_{vgg16,mobilenet}_state_dict).

  * --to_npz: write the renamed torch-key dict (torchvision / reference
    keys) as .npz and stop;
  * --out: build the port's FasterRCNN (--net, --net_type, --en_fpn,
    --num_classes; seed-0 init for what the checkpoint lacks), copy the
    converted tensors in, and save its state dict as a .pt that
    trainval_net_torch.py --weights_file, test_net_torch.py and
    demo_torch.py read.  For --net_type lidar an RGB stem is spread over
    the BEV stem's channels (replicate_conv1_for_lidar).

The VGG16 rename keeps tf-slim's scope as a 'vgg.' prefix on every key,
which the torchvision key map (vgg16_key_to_flax) does not read; the prefix
is dropped before loading, so that the convs and fc6/fc7 load.  A ResNet's
'resnet.' keys, prefix dropped, are a torchvision ResNet's backbone and C4
tail, loaded strictly (a missing or misshapen tensor raises); the
checkpoint's RPN and class heads are left out, as the JAX package's
ResNet key map leaves them.

Reading a real .ckpt needs tensorflow (imported only then); an .npz of raw
tf-slim variables needs nothing but numpy.

    python tools/convert_from_tensorflow_torch.py vgg16.npz --net vgg16 --out vgg16_port.pt
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def read_tf_checkpoint(path: str) -> dict:
    """{variable name: ndarray} from a TF checkpoint (needs tensorflow) or
    an .npz of raw tf-slim variables."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    try:
        import tensorflow as tf
    except ImportError as e:
        sys.exit(f"reading a .ckpt needs tensorflow ({e}); export the variables to .npz on a "
                 "machine that has it, or pass an .npz directly")
    reader = tf.train.load_checkpoint(path)
    return {k: reader.get_tensor(k) for k in reader.get_variable_to_shape_map()}


def main(argv=None):
    p = argparse.ArgumentParser(description="tf-slim -> torch keys / the port's state dict")
    p.add_argument("tf_ckpt", type=str, help=".ckpt prefix or .npz of variables")
    p.add_argument("--net", default="res101",
                   choices=("res50", "res101", "res152", "vgg16", "mobile"))
    p.add_argument("--to_npz", default=None, help="write the torch-key dict here and stop")
    p.add_argument("--out", default=None, help="write the port's state dict (.pt) here")
    p.add_argument("--net_type", default="image", type=str)
    p.add_argument("--en_fpn", default=0, type=int)
    p.add_argument("--num_classes", default=2, type=int)
    p.add_argument("--verbose", action="store_true",
                   help="print the vgg16 / mobile keys that are skipped")
    args = p.parse_args(argv)

    from faster_rcnn_pytorch_multimodal_tpu_torch.utils import convert

    var_dict = read_tf_checkpoint(args.tf_ckpt)
    rename = {"vgg16": convert.tf_slim_vgg_to_torch,
              "mobile": convert.tf_slim_mobilenet_to_torch}.get(args.net,
                                                               convert.tf_slim_resnet_to_torch)
    torch_sd = rename(var_dict)
    print(f"{len(var_dict)} tf variables -> {len(torch_sd)} torch-key tensors")
    if args.to_npz:
        np.savez(args.to_npz, **torch_sd)
        print(f"wrote {args.to_npz}")
        return
    if not args.out:
        return

    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list, default_config
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import init_detector

    cfg = cfg_from_list(default_config(), (
        "NET_TYPE", args.net_type, "NET_VARIANT", args.net, "USE_FPN", bool(args.en_fpn),
        "POOLING_MODE", "multiscale" if args.en_fpn else "align"))
    model = init_detector(cfg, args.num_classes)
    if args.net == "vgg16":
        torch_sd = {k[len("vgg."):] if k.startswith("vgg.") else k: v for k, v in torch_sd.items()}
        load = convert.load_vgg16_state_dict
        stem = "features.0.weight"
    elif args.net == "mobile":
        load = convert.load_mobilenet_state_dict
        stem = "mobilenet.Conv2d_0.0.weight"
    else:
        torch_sd = {k[len("resnet."):]: v for k, v in torch_sd.items() if k.startswith("resnet.")}
        stem = "conv1.weight"
    if args.net_type == "lidar" and stem in torch_sd:
        torch_sd = convert.replicate_conv1_for_lidar(
            torch_sd, cfg.lidar.num_slices, cfg.lidar.num_channel, stem)
    if args.net.startswith("res"):
        n = convert.load_torchvision_resnet(
            model, {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in torch_sd.items()})
    else:
        n = load(model, torch_sd, verbose=args.verbose)
    print(f"loaded {n} tensors from {args.tf_ckpt}")
    torch.save(model.state_dict(), args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
