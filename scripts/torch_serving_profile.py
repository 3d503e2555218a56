"""Where the time of one FastSCNN serving request goes on the card, for the
PyTorch port: bf16, batch 8 of 1024x2048 uint8 frames, 19 classes,
`upsample_logits=False`, as in chip_smoke.py.

    python3 scripts/torch_serving_profile.py [--requests 3]

Prints the card, the request time (host clock around a synchronised
request), the device busy time per request from torch.profiler (the sum of
kernel times), the top kernels by device time, and one JSON line. Needs a
CUDA card.
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
from torch_semantic_segmentation_tpu_torch.serving import (  # noqa: E402
    make_predict_fn)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{chip_smoke.smi_line()}", flush=True)
    frames = torch.from_numpy(chip_smoke.make_frames(0)).cuda()
    state = chip_smoke.calibrated_state(frames)
    predict = make_predict_fn(chip_smoke.build_model(torch.bfloat16, state),
                              output="ids")
    for _ in range(2):                       # warm-up
        predict(frames)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.requests):
        predict(frames)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / args.requests

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.requests):
            predict(frames)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    busy_ms = total_us / 1e3 / args.requests
    print(f"request {wall_ms:.3f} ms (host clock); device busy {busy_ms:.3f} "
          f"ms a request (profiler), idle share {1 - busy_ms / wall_ms:.3f}",
          flush=True)
    print(f"{'kernel':<90} {'ms/request':>10} {'share':>6} {'calls':>6}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        ms = e.self_device_time_total / 1e3 / args.requests
        print(f"{e.key[:90]:<90} {ms:10.4f} {ms / busy_ms:6.3f} "
              f"{e.count // args.requests:6d}")
    print(json.dumps({"request_ms": wall_ms, "device_busy_ms": busy_ms,
                      "kernels": len(events)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
