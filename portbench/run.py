"""Run one benchmark cell of the PyTorch/CUDA port once and print its result.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell (BENCHMARK.json and the files it names), makes the inputs
and weights from the seed, warms up, measures for --seconds, then checks
what the timed path produced against the plain reference.  The last line of
standard output is one JSON object: correct, attempted, failed, metrics
(--trace 0: the cell's end-to-end metrics; --trace 1: its per-layer
metrics), breakdown (traced), device, and last the compared numbers with
their limits, which also end standard error.  Needs an NVIDIA GPU: without
one, or with fewer than the cell asks for, it exits 2 and prints no result.
"""

import time

T0 = time.time()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HOST_THREADS = 2


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed place inside the checkout (the
    port's own nvcc library already lives in build/kernels/)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    # one process with few threads: the host's share of a step is Python and launches
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(HOST_THREADS)

    from portbench import cells, harness

    cell = cells.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0, ROOT)
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
