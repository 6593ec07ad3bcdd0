#!/usr/bin/env python
"""Demo drawing ALL classes' detections on one canvas, one colour a class:
the port of tools/demo_all_bboxes.py (ref tools/demo_all_bboxes.py:53-124:
tab10 colour cycle, CONF_THRESH 0.8).

A thin wrapper over tools/demo_torch.py: the same flags, with
--class_colors 1, --thresh 0.8 and --out demo_all_bboxes_out.png unless
given.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None):
    import demo_torch

    argv = list(sys.argv[1:] if argv is None else argv)
    # PREPEND the defaults: demo_torch.py's --set is nargs=REMAINDER, so
    # anything appended after a user-supplied --set would join set_cfgs
    prefix = ["--class_colors", "1"]
    if not any(a.startswith("--thresh") for a in argv):
        prefix += ["--thresh", "0.8"]  # ref demo_all_bboxes.py:69 CONF_THRESH
    if not any(a.startswith("--out") for a in argv):
        prefix += ["--out", "demo_all_bboxes_out.png"]
    return demo_torch.main(prefix + argv)


if __name__ == "__main__":
    main()
