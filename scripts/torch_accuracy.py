"""Accuracy runs of the port through its train CLI: the eight runs of
`scripts/make_accuracy_artifact.py` (FastSCNN on the default and the
fused-resize route, ENet with CE and with OHEM, ESNet, ERFNet, LEDNet and
UNet), each on `ShapesDataset` at batch 8, crop 128, scale 0.75-1.25, SGD
lr 0.05, 400 steps with a val mIoU every 100 (4 batches).

    python3 scripts/torch_accuracy.py [--runs esnet erfnet] [--seeds 0 1 2]

Prints one JSON line a run and seed: its name, model, flags, seed, eval
curve, the CLI's img/s at each log step, the best val mIoU and whether it
passes the JAX artifact's mark of 70, then the card's name and power
limit. Exits 1 when a run misses the mark.

This file is also the one home of the recipe and of reading the CLI's
printed lines back (`recipe`, `read_curve`, `run_cli`): `chip_smoke.py`
phase 13 loads it from here.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

RUNS = (("default", "fastscnn", ()),
        ("fused_resize", "fastscnn", ("--fused-resize-loss",)),
        ("enet", "enet", ()),
        ("enet_ohem", "enet", ("--loss", "ohem")),
        ("esnet", "esnet", ()),
        ("erfnet", "erfnet", ()),
        ("lednet", "lednet", ()),
        ("unet", "unet", ()))
BATCH, CROP = 8, 128
STEPS, EVERY, PASS_MARK = 400, 100, 70.0


class Tee:
    """Writes to a stream and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, s):
        self.stream.write(s)
        self.parts.append(s)
        return len(s)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


def run_cli(fn, argv):
    """`fn(argv)` with its standard output shown and kept: (its result,
    the text it printed)."""
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = fn(argv)
    return out, tee.text()


def recipe(checkpoint_dir: str) -> list[str]:
    """The accuracy recipe's flags (`make_accuracy_artifact.py:58-63`)."""
    return ["--dataset", "shapes", "--batch-size", str(BATCH),
            "--crop-size", str(CROP), "--scale-range", "0.75", "1.25",
            "--lr", "0.05", "--max-iterations", str(STEPS),
            "--eval-every", str(EVERY), "--eval-batches", "4",
            "--log-every", str(EVERY), "--checkpoint-dir", checkpoint_dir,
            "--checkpoint-every", str(STEPS)]


def read_curve(out: str) -> tuple[list[tuple[int, float]], list[float]]:
    """The eval curve [(step, val mIoU)] and the img/s of each log line
    that the train CLI printed."""
    curve = [(int(m.group(1)), float(m.group(2)))
             for m in re.finditer(r"it (\d+) val mIoU ([\d.]+)", out)]
    rates = [float(m.group(1)) for m in re.finditer(r"img/s ([\d.]+)", out)]
    return curve, rates


def train_run(model: str, flags, seed: int) -> dict:
    from torch_semantic_segmentation_tpu_torch.cli.train import main

    ckpt = tempfile.mkdtemp(prefix="torch_accuracy_")
    t0 = time.perf_counter()
    try:
        _, out = run_cli(main, ["--model", model, *recipe(ckpt), *flags,
                                "--seed", str(seed)])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    curve, rates = read_curve(out)
    best = max((v for _, v in curve), default=None)
    return {"eval_curve": [{"step": s, "val_miou": v} for s, v in curve],
            "img_s": rates, "best_val_miou": best,
            "passed": best is not None and best > PASS_MARK,
            "seconds": time.perf_counter() - t0}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--runs", nargs="+", default=[name for name, _, _ in RUNS],
                   choices=[name for name, _, _ in RUNS])
    p.add_argument("--seeds", type=int, nargs="+", default=[0],
                   help="the train CLI's --seed: the weights, the "
                        "augmentation and the shuffle")
    args = p.parse_args()
    ok = True
    for name, model, flags in RUNS:
        if name not in args.runs:
            continue
        for seed in args.seeds:
            r = train_run(model, flags, seed)
            ok &= r["passed"]
            print(json.dumps({"run": name, "model": model,
                              "flags": list(flags), "seed": seed, **r}),
                  flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
