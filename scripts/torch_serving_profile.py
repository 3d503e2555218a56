"""Where the time of one FastSCNN serving request goes on the card, for the
PyTorch port: bf16, batch 8 of 1024x2048 uint8 frames, 19 classes,
`upsample_logits=False`, as in chip_smoke.py.

    python3 scripts/torch_serving_profile.py [--requests 3] [--root DIR]

`--root` names the checkout whose port package is profiled (default: this
one), e.g. a `git archive` of the parent under the ignored `_chipcheck/`.
Prints the card, the request time (host clock around a synchronised
request), the device busy time per request from torch.profiler (the sum of
kernel times), the device operations (kernels, copies) per request, the
top kernels by device time, and one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    sys.path.insert(0, root)
    import chip_smoke
    from torch_semantic_segmentation_tpu_torch.serving import make_predict_fn

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"root {root}; device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
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
    ops = sum(e.count for e in events) / args.requests
    print(f"request {wall_ms:.3f} ms (host clock); device busy {busy_ms:.3f} "
          f"ms a request (profiler), idle share {1 - busy_ms / wall_ms:.3f}; "
          f"{ops:g} device operations (kernels, copies) a request",
          flush=True)
    print(f"{'kernel':<90} {'ms/request':>10} {'share':>6} {'calls':>6}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        ms = e.self_device_time_total / 1e3 / args.requests
        print(f"{e.key[:90]:<90} {ms:10.4f} {ms / busy_ms:6.3f} "
              f"{e.count // args.requests:6d}")
    print(json.dumps({"root": root, "request_ms": wall_ms,
                      "device_busy_ms": busy_ms, "kernels": len(events),
                      "device_ops_a_request": ops}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
