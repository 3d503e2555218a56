"""Serving, phase 6's main path and phase 14 of `chip_smoke.py`, for this
checkout or another, on the card: parent against change in one call.

    python3 scripts/torch_main_path_compare.py [--root DIR] [--label NAME]
        [--log-dir DIR]

In a process of its own, with `--root` (default: this checkout) as its
working directory and first on its path, it builds the five kernels (one
nvcc each, in parallel), then runs that checkout's `chip_smoke.serve()`
(FastSCNN bf16 at 8x1024x2048), `train_augmented()` (phase 6: 1 + 8
steps through `augment_batch`) and `dp_phase()` (phase 14: the NCCL
group of one held against no group, bit for bit with K2 unrouted, and
two gloo ranks through the train CLI). With `--log-dir` their lines go
to DIR/compare_<label>.log; the script prints the lines that carry the
numbers, and one JSON line: each latency list's median on the
host clock, the CUDA-event medians of phase 6's and the group's steps,
the command's seconds, the card's name and power limit. For parent
against change: `git archive <parent> | tar -x -C _chipcheck/parent`,
then in one command on the card run `--root _chipcheck/parent --label
p1`, this checkout twice (`c1`, `c2`) and the parent again (`p2`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r"""
import json
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import chip_smoke as c
from torch_semantic_segmentation_tpu_torch import kernels
names = ("sepconv", "resize_ce", "mbconv", "depthwise", "upsample_concat")
with ThreadPoolExecutor(len(names)) as pool:
    list(pool.map(kernels.build, names))
served = c.serve()
main_path = c.train_augmented()
main_path.pop("model")
main_path.pop("batch")
dp = c.dp_phase(main_path)
med = lambda v: float(np.median(v))
print("RESULT " + json.dumps({
    "serve_ms": med(served["latency_ms"]),
    "train_ms": med(main_path["latency_ms"]),
    "train_device_ms": med(main_path["device_ms"]),
    "group_device_ms": med(dp["group_of_one"]["device_ms"]),
    "group_base_device_ms": med(dp["group_of_one"]["base_device_ms"])}))
"""

KEEP = ("serve bf16", "train bf16 with augmentation", "dp group of one, K2",
        "dp group of one: losses", "dp phase:", "RESULT", "FAIL")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="change")
    ap.add_argument("--log-dir", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=root, env=env,
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        with open(os.path.join(args.log_dir, f"compare_{args.label}.log"),
                  "w") as f:
            f.write(proc.stdout + proc.stderr)
    result = {}
    for line in proc.stdout.splitlines():
        if line.startswith(KEEP):
            print(f"[{args.label}] {line[:600]}", flush=True)
        if line.startswith("RESULT "):
            result = json.loads(line[len("RESULT "):])
    print(json.dumps({"label": args.label, "root": args.root, "rc":
                      proc.returncode, "seconds": round(seconds, 1),
                      "card": smi.strip(), **result}), flush=True)
    if proc.returncode:
        print(proc.stderr[-3000:], file=sys.stderr)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
