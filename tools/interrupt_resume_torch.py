#!/usr/bin/env python
"""Stop tools/trainval_net_torch.py with SIGINT and check that a second run
resumes where it stopped.

The training CLI runs with the flags after `--`.  Once the snapshot of the
last SNAPSHOT_ITERS step before --stop_after is on disk, SIGINT is sent
after the time of (stop_after - that step - 0.5) steps, a step's time taken
from the two display lines before it (less the val cycle and snapshot that
followed the later one), so that it arrives during step --stop_after or
close to it; the JSON line says where the run stopped.  The
CLI then snapshots after the step in flight and exits.  The same command
runs again in the same output directory.  Checked from the two logs and
OUT_DIR/NET_TYPE/DB/tb/scalars.jsonl: the first run stopped after iteration
n and wrote iter_n, the second restored iter_n, ran from n + 1 and ended at
--iters, and the train log holds every display step once.  Both logs are
written to --log_dir; the result is printed as one JSON line.

    python tools/interrupt_resume_torch.py --stop_after 25 -- --db synthetic --dbval synthetic --net res18 --fixed_blocks -1 --iters 40 --out_dir build/interrupt_resume --set TRAIN.SNAPSHOT_ITERS 20 TRAIN.DISPLAY 10
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--stop_after", type=int, required=True)
    p.add_argument("--log_dir", default="build/interrupt_resume_logs", type=str)
    p.add_argument("cli", nargs=argparse.REMAINDER, help="-- then the training CLI's flags")
    args = p.parse_args(argv)
    args.cli = args.cli[1:] if args.cli[:1] == ["--"] else args.cli
    return args


def _flag(argv, name, default):
    return argv[argv.index(name) + 1] if name in argv else default


def _set(argv, key, default):
    sets = argv[argv.index("--set") + 1:] if "--set" in argv else []
    return int(sets[sets.index(key) + 1]) if key in sets else default


def run(cmd, log_path, stop_after=None, ckpt_dir=None, snap_every=None, display=None):
    """One CLI run, its output teed to log_path; with stop_after, SIGINT as
    the module docstring says.  Returns (exit code, log text)."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    shown = {}
    lines = []

    def interrupt():
        try:
            wait_and_signal()
        except BaseException as e:  # shown, then the checks below fail
            print(f"interrupt_resume_torch: the interrupt failed: {e!r}", flush=True)

    def wait_and_signal():
        last = (stop_after - 1) // snap_every * snap_every
        snap = os.path.join(ckpt_dir, f"iter_{last}")
        while proc.poll() is None and not (os.path.exists(snap) and last - display in shown
                                           and last in shown):
            time.sleep(0.005)
        if proc.poll() is not None:
            return
        # the display lines are `display` steps and one val cycle apart; the
        # val cycle and the snapshot after the last line took until now
        after = time.perf_counter() - shown[last]
        span = shown[last] - shown[last - display]
        step_s = (span - after if span > after else span) / display
        time.sleep(max(stop_after - last - 0.5, 0.0) * step_s)
        proc.send_signal(signal.SIGINT)

    waiter = threading.Thread(target=interrupt, daemon=True) if stop_after else None
    if waiter is not None:
        waiter.start()
    with open(log_path, "w") as log:
        for line in proc.stdout:
            m = re.match(r"iter: (\d+) / \d+", line)
            if m:
                shown[int(m.group(1))] = time.perf_counter()
            lines.append(line)
            log.write(line)
            log.flush()
    return proc.wait(), "".join(lines)


def main(argv=None):
    args = parse_args(argv)
    cli = args.cli
    iters = int(_flag(cli, "--iters", "20"))
    out = os.path.join(_flag(cli, "--out_dir", "output"), _flag(cli, "--net_type", "image"),
                       f"synthetic_{_flag(cli, '--net_type', 'image')}_train")
    snap_every = _set(cli, "TRAIN.SNAPSHOT_ITERS", 5000)
    display = _set(cli, "TRAIN.DISPLAY", 512)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(args.log_dir, exist_ok=True)
    cmd = [sys.executable, "-u", os.path.join(TOOLS, "trainval_net_torch.py")] + cli
    ckpt = os.path.join(out, "checkpoints")
    rc1, log1 = run(cmd, os.path.join(args.log_dir, "first.log"), args.stop_after, ckpt,
                    snap_every, display)
    stopped = re.search(r"stopped by a signal after iteration (\d+)", log1)
    n = int(stopped.group(1)) if stopped else None
    snaps_after_stop = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
    rc2, log2 = run(cmd, os.path.join(args.log_dir, "second.log"))
    restored = re.search(r"restoring from \S*iter_(\d+)", log2)
    done = re.search(r"done at iteration (\d+)", log2)
    with open(os.path.join(out, "tb", "scalars.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    want_steps = sorted({s for s in range(display, iters + 1, display)} | {iters})
    result = {
        "first_rc": rc1, "stopped_after": n, "snapshots_after_stop": snaps_after_stop,
        "second_rc": rc2, "restored": int(restored.group(1)) if restored else None,
        "first_iter_logged_after_restore": min(
            (int(m) for m in re.findall(r"iter: (\d+) /", log2)), default=None),
        "ended_at": int(done.group(1)) if done else None, "scalars_steps": steps,
    }
    ok = (rc1 == 0 and rc2 == 0 and n is not None and f"iter_{n}" in snaps_after_stop
          and result["restored"] == n and result["ended_at"] == iters
          and steps == want_steps)
    result["ok"] = ok
    print(json.dumps(result))
    if not ok:
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    main()
