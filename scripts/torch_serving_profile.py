"""Where the time of one FastSCNN serving request goes on the card, for the
PyTorch port: bf16, batch 8 of 1024x2048 uint8 frames, 19 classes,
`upsample_logits=False`, as in chip_smoke.py.

    python3 scripts/torch_serving_profile.py [--requests 3] [--root DIR] [--aot]

`--root` names the checkout whose port package is profiled (default: this
one), e.g. a `git archive` of the parent under the ignored `_chipcheck/`.
Prints the card, the request time (host clock around a synchronised
request), the device busy time per request from torch.profiler (the sum of
kernel times), the device operations (kernels, copies) per request, the
top kernels by device time, and one JSON line. With `--aot` the same for
the predictor `serving.aot_compile` captured as one CUDA graph, after the
eager predictor's, in the same process. Needs a CUDA card.
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


def profile_requests(what: str, predict, frames, requests: int) -> dict:
    """Host ms a synchronised request, then the profiler's device busy ms,
    idle share and device operations a request; prints the top kernels."""
    t0 = time.perf_counter()
    for _ in range(requests):
        predict(frames)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / requests

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(requests):
            predict(frames)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    busy_ms = total_us / 1e3 / requests
    ops = sum(e.count for e in events) / requests
    print(f"{what}: request {wall_ms:.3f} ms (host clock); device busy "
          f"{busy_ms:.3f} ms a request (profiler), idle share "
          f"{1 - busy_ms / wall_ms:.3f}; {ops:g} device operations (kernels, "
          f"copies) a request", flush=True)
    print(f"{'kernel':<90} {'ms/request':>10} {'share':>6} {'calls':>6}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        ms = e.self_device_time_total / 1e3 / requests
        print(f"{e.key[:90]:<90} {ms:10.4f} {ms / max(busy_ms, 1e-9):6.3f} "
              f"{e.count // requests:6d}")
    return {"request_ms": wall_ms, "device_busy_ms": busy_ms,
            "kernels": len(events), "device_ops_a_request": ops}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--aot", action="store_true",
                    help="also profile the aot_compile'd predictor")
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

    report = {"root": root,
              "eager": profile_requests("eager", predict, frames,
                                        args.requests)}
    if args.aot:
        from torch_semantic_segmentation_tpu_torch.serving import aot_compile
        compiled = aot_compile(predict, *frames.shape[:3])
        for _ in range(2):                   # warm-up
            compiled(frames)
        torch.cuda.synchronize()
        report["aot"] = profile_requests("aot", compiled, frames,
                                         args.requests)
        report["aot"]["compile_s"] = compiled.seconds
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
