#!/usr/bin/env python3
"""Time variants of csrc/nms.cu's mask kernels on one NVIDIA GPU, in turns.

    python tools/nms_variants_torch.py [--rounds 2] [--out build/nms_variants.json]

Each variant is csrc/nms.cu with a line or two replaced (VARIANTS), compiled by
nvcc with the kernels' flags (ops/_build.py NVCC_FLAGS) into a library of
its own under build/nms_variants/, and run through the port's NMS wrapper
(ops/nms.py) in place of the built library.  The axis-aligned variants run
at chip_smoke.py's five K1 shapes (chip_smoke.nms_problems), the rotated
ones on three sets of (16, 300) problems @ 0.3: what the rotated BEV
serving path's final filter gives NMS in its first batch (res101 bf16,
batch 8, random weights from seed 0: chip_smoke.run_bev_serving), and
chip_smoke's random and dense sets.  Round after round, each set runs
every variant in turn (the order reversed every other round), timing the
whole call's device time (chip_smoke.kernel_ms) and the sort, mask and
scan kernels' (chip_smoke.profile_kernels).  Every variant's keeps on a
set must be equal.  Needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

ROT_THREADS = "constexpr int kRotMaskThreads = 256;"
IN_PLACE = "if (ballot == 0xffffffffu) {  // every lane meets: clip in place"
IN_PLACE_CLIP = "__ballot_sync(0xffffffffu, rot_iou_clipped(a, scol[c]) > threshold)"
# name -> (kernel family, [(a line of nms.cu, its replacement), ...])
VARIANTS = {
    "kept": ("both", []),
    "rows 4": ("axis-aligned", [("constexpr int kRowThreads = 2;",
                                 "constexpr int kRowThreads = 4;")]),
    "rot 128": ("rotated", [(ROT_THREADS, "constexpr int kRotMaskThreads = 128;")]),
    "rot 512": ("rotated", [(ROT_THREADS, "constexpr int kRotMaskThreads = 512;")]),
    # a half-row with any meeting pair clips in place, its other lanes idle
    "no queue": ("rotated", [(IN_PLACE, "if (ballot != 0u) {"),
                             (IN_PLACE_CLIP, "__ballot_sync(0xffffffffu, meet && "
                                             "rot_iou_clipped(a, scol[c]) > threshold)")]),
    # every meeting pair goes through the queue
    "no in-place": ("rotated", [(IN_PLACE, "if (false) {")]),
}
ENTRIES = ("frcnn_nms_workspace_bytes", "frcnn_nms", "frcnn_nms_rotated", "frcnn_nms_sort")


def build_variants(out_dir: Path) -> dict:
    """Compile every variant, all nvcc processes started together; returns
    {name: ctypes library} with the entries' signatures of the built one."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build

    text = (_build.CSRC / "nms.cu").read_text()
    procs = {}
    for name, (_, edits) in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in nms.cu once")
            src = src.replace(old, new)
        d = out_dir / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "nms.cu").write_text(src)
        procs[name] = (d / "libnms.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "libnms.so"),
             str(d / "nms.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = _build.library()
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(path))
        for entry in ENTRIES:
            getattr(lib, entry).argtypes = getattr(built, entry).argtypes
            getattr(lib, entry).restype = getattr(built, entry).restype
        libs[name] = lib
    return libs


def problem_sets(smi: str) -> list:
    """(label, family, boxes, scores, valid, threshold, max_out) numpy sets."""
    sets = []
    for label, g, n, thr, max_out in (("proposals", 8, 2048, 0.7, 300),
                                      ("final filter", 16, 300, 0.6, 100),
                                      ("train proposals", 8, 4096, 0.7, 2000),
                                      ("BEV proposals", 8, 1100, 0.7, 300),
                                      ("BEV train proposals", 8, 1024, 0.7, 1024)):
        problems = chip_smoke.nms_problems(np.random.RandomState(0), g, n)
        sets.append((label, "axis-aligned", *problems, thr, max_out))
    cfg = chip_smoke.make_config(chip_smoke.BEV_OVERRIDES, chip_smoke.BEV_SERVING_OVERRIDES,
                                 chip_smoke.ROTATED_OVERRIDES)
    _, stats = chip_smoke.run_bev_serving(cfg, smi,
                                          need=("voxelize_bev", "nms", "nms_rotated", "roi_align"))
    f = stats["filter_input"]
    sets.append(("BEV filter input", "rotated", f["boxes"], f["scores"], f["valid"], f["thr"],
                 f["max_out"]))
    rng = np.random.RandomState(0)
    boxes = chip_smoke.rotated_boxes(rng, 16, 300)
    scores = rng.uniform(size=(16, 300)).astype(np.float32)
    sets.append(("random", "rotated", boxes, scores, np.ones((16, 300), bool), 0.3, 100))
    rng = np.random.RandomState(3)
    boxes = chip_smoke.dense_rotated_boxes(rng, 16, 300)
    scores = rng.uniform(size=(16, 300)).astype(np.float32)
    sets.append(("dense", "rotated", boxes, scores, rng.uniform(size=(16, 300)) < 0.9, 0.3, 100))
    return sets


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=str(REPO / "build" / "nms_variants.json"))
    args = ap.parse_args()
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.nms import nms

    if not torch.cuda.is_available():
        print("nms_variants_torch: no CUDA device", file=sys.stderr)
        return 1
    smi = chip_smoke.smi_name_power()
    print(f"nvidia-smi: {smi}", flush=True)
    libs = build_variants(REPO / "build" / "nms_variants")
    sets = problem_sets(smi)
    for label, family, boxes, _, valid, _, _ in sets:
        if family == "rotated":
            upper = np.triu(np.ones(valid.shape[-1:] * 2, bool), 1)
            meet = int((chip_smoke.circles_meet(boxes) & upper).sum())
            pairs = int(upper.sum()) * len(boxes)
            print(f"{label}: bounding circles meet on {meet} of {pairs} upper-triangle pairs "
                  f"({meet / pairs}); valid lanes {int(valid.sum())} of {valid.size}", flush=True)
    rows = []
    for rnd in range(args.rounds):
        for label, family, boxes, scores, valid, thr, max_out in sets:
            rotated = family == "rotated"
            names = [k for k, v in VARIANTS.items() if v[0] in ("both", family)]
            if rnd % 2:
                names.reverse()
            db, ds, dv = (torch.from_numpy(a).cuda() for a in (boxes, scores, valid))
            kernels = chip_smoke.ROT_NMS_KERNELS if rotated else chip_smoke.NMS_KERNELS
            want = None
            for name in names:
                with mock.patch.object(_build, "library", lambda lib=libs[name]: lib):
                    def call():
                        return nms(db, ds, thr, max_out, dv, rotated=rotated)
                    got = tuple(t.cpu() for t in call())
                    if want is None:
                        want = got
                    elif not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"{label} {name}: keeps differ from {names[0]}'s")
                    t = chip_smoke.kernel_ms(call, 20)
                    split = chip_smoke.profile_kernels(call, 10, *kernels)
                row = {"round": rnd, "set": label, "variant": name, "ms": t["ms"],
                       **{k.replace("nms_", "").replace("_kernel", "") + "_ms": v
                          for k, v in split.items()}}
                rows.append(row)
                print(json.dumps(row), flush=True)
    summary = {}
    for row in rows:
        key = f"{row['set']} | {row['variant']}"
        mask = row.get("mask_ms", row.get("rotated_mask_ms"))
        summary.setdefault(key, []).append((row["ms"], mask))
    print(f"{smi}: set | variant: [(whole ms, mask ms) by round]")
    for key, v in summary.items():
        print(f"  {key}: {v}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
