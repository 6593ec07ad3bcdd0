"""The control of a cell: the reference computed in float8 (e4m3, a scale a
tensor, on every convolution's and dense layer's inputs) put in the
program's place, judged exactly as the program is.  Its numbers are the
upper readings that the limits in portbench/limits/ sit below.

  python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line a seed: the compared numbers and whether they pass
the cell's limits (a sound control fails at least one).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(cell, seed: int, device, fault: str = "") -> dict:
    """The numbers of the fp8 control, or with `fault` (training: half_batch)
    of the float32 reference with that fault planted, in the program's place."""
    import torch

    from portbench import harness, judge, traffic
    from portbench.reference.config import reference_config
    from portbench.reference.model import Detector

    rcfg = reference_config(cell.config["overrides"])
    det = Detector(rcfg, cell.config["num_classes"], device)
    pool = traffic.make_pool(cell.traffic, harness.frame_config(cell, det), seed, device,
                             pin=False)
    if cell.traffic["path"] == "train":
        rec = judge.reference_train(det, pool, seed, device, q=None if fault else judge.fp8,
                                    half=fault == "half_batch")
        return judge.judge_train(det, pool, seed, device, rec)
    served = {"bfloat16": torch.bfloat16, "float32": torch.float32}[rcfg["COMPUTE_DTYPE"]]
    t = cell.traffic
    picks = [o % len(pool) for o in judge.sample_ordinals(seed, t["sample_from"], t["samples"])]
    rec = judge.reference_serve(det, pool, seed, device, served, picks, q=judge.fp8)
    return judge.judge_serve(det, pool, seed, device, served, rec)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=("", "half_batch"), default="",
                   help="plant a fault in the float32 reference instead of computing in fp8")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import cells

    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = cells.load_cell(args.workload, ROOT)
    for seed in args.seeds:
        t = time.time()
        nums = control_numbers(cell, seed, "cuda", args.fault)
        fails = [k for k, lim in cell.limits.items() if not nums[k] <= lim]
        print(json.dumps({"workload": args.workload, "fault": args.fault or "fp8", "seed": seed,
                          "numbers": nums,
                          "fails": fails, "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
