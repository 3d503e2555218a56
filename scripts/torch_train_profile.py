"""Where the time of one FastSCNN training step goes on the card, for the
PyTorch port: bf16 compute with float32 parameters, batch 8 of 1024x2048
uint8 frames, 19 classes, `upsample_logits=False` with the x8 resize inside
the loss, SGD as in chip_smoke.py. The frames are normalised on the card,
or with `--augment` drawn through `augment_batch` at crop 1024x2048 before
each step (`bench.py`'s fullres tier).

    python3 scripts/torch_train_profile.py [--steps 3] [--augment]

Prints the card, the step time (host clock around a synchronised step), the
device busy time per step from torch.profiler (the sum of kernel times),
the top kernels by device time, the port's own kernels (K1, K2 and K6) by
name, and one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from torch_semantic_segmentation_tpu_torch.data.transforms import (  # noqa: E402
    AugmentConfig, augment_batch, normalize_batch)
from torch_semantic_segmentation_tpu_torch.losses import (  # noqa: E402
    resize_cross_entropy_loss)
from torch_semantic_segmentation_tpu_torch.models import get_model  # noqa: E402
from torch_semantic_segmentation_tpu_torch.train import (  # noqa: E402
    OptimizerConfig, create_train_state, make_train_step)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--augment", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{chip_smoke.smi_line()}", flush=True)
    frames, labels = chip_smoke.make_batch(100)
    frames = torch.from_numpy(frames).cuda()
    labels = torch.from_numpy(labels).cuda()
    model = get_model("fastscnn", chip_smoke.NUM_CLASSES,
                      upsample_logits=False, compute_dtype=torch.bfloat16,
                      seed=0, device="cuda")
    state = create_train_state(model, OptimizerConfig(lr=0.045,
                                                      max_steps=1000))
    inner = make_train_step(model, state, resize_cross_entropy_loss)
    if args.augment:
        cfg = AugmentConfig(crop=(chip_smoke.SERVE_H, chip_smoke.SERVE_W),
                            out_dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def step(raw, lab):
            return inner(*augment_batch(raw, lab, gen, cfg))
        images = frames
    else:
        step = inner
        images = normalize_batch(frames)
    for _ in range(2):                       # warm-up
        step(images, labels)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(images, labels)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step(images, labels)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    busy_ms = total_us / 1e3 / args.steps
    print(f"step {wall_ms:.3f} ms (host clock); device busy {busy_ms:.3f} "
          f"ms a step (profiler), idle share {1 - busy_ms / wall_ms:.3f}",
          flush=True)

    def show(rows):
        print(f"{'kernel':<90} {'ms/step':>9} {'share':>6} {'calls':>6}")
        for e in rows:
            ms = e.self_device_time_total / 1e3 / args.steps
            print(f"{e.key[:90]:<90} {ms:9.4f} {ms / busy_ms:6.3f} "
                  f"{e.count // args.steps:6d}")

    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    show(ranked[:30])
    print("the port's kernels:")
    show([e for e in ranked
          if any(n in e.key for n in ("resize_ce", "mbconv", "dw_"))])
    print(json.dumps({"step_ms": wall_ms, "device_busy_ms": busy_ms,
                      "kernels": len(events), "augment": args.augment}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
