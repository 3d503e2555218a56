"""Where the time of one training step goes on the card, for the PyTorch
port: bf16 compute with float32 parameters, 19 classes, SGD as in
chip_smoke.py.

- FastSCNN (the default): batch 8 of 1024x2048 uint8 frames,
  `upsample_logits=False` with the x8 resize inside the loss. The frames
  are normalised on the card, or with `--augment` drawn through
  `augment_batch` at crop 1024x2048 before each step (`bench.py`'s fullres
  tier).
- `--model bisenet | icnet`: BASELINE config 5 as chip_smoke.py's phase 9
  runs it (BiSeNet-R18 or ICNet-R50, batch 16 of 1024x1024 crops through
  `augment_batch`, aux heads and OHEM, each head through K3).
- `--model enet`: BASELINE config 1 as its phase 10 runs it (batch 4 of
  512x512 crops, class-weighted CE).
- `--model erfnet | esnet | lednet | contextnet`: the stretch zoo as its
  phase 11 trains it (768x768 crops through `augment_batch`, SGD lr 0.045,
  batch 8, ContextNet 32; LEDNet and ContextNet with 1/8 logits and the
  resize CE, the others with plain CE).

    python3 scripts/torch_train_profile.py [--steps 3] [--augment]
        [--model fastscnn|bisenet|icnet|enet|erfnet|esnet|lednet|contextnet]

Prints the card, the step time (host clock around a synchronised step), the
device busy time per step from torch.profiler (the sum of kernel times) and
the kernel launches a step, the top kernels by device time, the port's own
kernels (K1, K2, K3 and K6) by name, and one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from torch_semantic_segmentation_tpu_torch.data.class_weights import (  # noqa: E402
    compute_class_weights)
from torch_semantic_segmentation_tpu_torch.data.transforms import (  # noqa: E402
    AugmentConfig, augment_batch, normalize_batch)
from torch_semantic_segmentation_tpu_torch.losses import (  # noqa: E402
    cross_entropy_loss, resize_cross_entropy_loss)
from torch_semantic_segmentation_tpu_torch.models import get_model  # noqa: E402
from torch_semantic_segmentation_tpu_torch.train import (  # noqa: E402
    OptimizerConfig, create_train_state, make_train_step)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--augment", action="store_true")
    ap.add_argument("--model", default="fastscnn",
                    choices=("fastscnn", "bisenet", "icnet", "enet",
                             *chip_smoke.STRETCH_MODELS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{chip_smoke.smi_line()}; model {args.model}", flush=True)
    c = chip_smoke.NUM_CLASSES
    if args.model == "fastscnn":
        frames, labels = chip_smoke.make_batch(100)
        model = get_model("fastscnn", c, upsample_logits=False,
                          compute_dtype=torch.bfloat16, seed=0, device="cuda")
        lr, loss_fn = 0.045, resize_cross_entropy_loss
        crop = (chip_smoke.SERVE_H, chip_smoke.SERVE_W)
        scale = AugmentConfig.scale_range
    elif args.model == "enet":
        frames, labels = (a[:chip_smoke.ENET_BATCH]
                          for a in chip_smoke.make_batch(100))
        cw = compute_class_weights([(None, lb) for lb in labels], c)
        model = get_model("enet", c, compute_dtype=torch.bfloat16, seed=0,
                          device="cuda")
        lr = chip_smoke.ENET_LR
        loss_fn = functools.partial(cross_entropy_loss,
                                    class_weights=torch.from_numpy(cw).cuda())
        crop = (chip_smoke.ENET_CROP, chip_smoke.ENET_CROP)
        scale = chip_smoke.ENET_SCALE
    elif args.model in chip_smoke.STRETCH_MODELS:
        frames, labels = chip_smoke.stretch_batch(
            100, chip_smoke.STRETCH_BATCH[args.model])
        low_res = args.model in chip_smoke.STRETCH_LOW_RES
        model = get_model(args.model, c, compute_dtype=torch.bfloat16, seed=0,
                          device="cuda",
                          **({"upsample_logits": False} if low_res else {}))
        lr = chip_smoke.ZOO_LR
        loss_fn = resize_cross_entropy_loss if low_res else cross_entropy_loss
        crop = (chip_smoke.ZOO_CROP, chip_smoke.ZOO_CROP)
        scale = AugmentConfig.scale_range
    else:
        pairs = [chip_smoke.make_batch(100), chip_smoke.make_batch(101)]
        frames, labels = (np.concatenate([p[i] for p in pairs])
                          for i in (0, 1))
        model = get_model(args.model, c,
                          depth=dict(chip_smoke.CONFIG5_MODELS)[args.model],
                          upsample_logits=False, compute_dtype=torch.bfloat16,
                          seed=0, device="cuda")
        lr, loss_fn = chip_smoke.CONFIG5_LR, chip_smoke.config5_loss()
        crop = (chip_smoke.CONFIG5_CROP, chip_smoke.CONFIG5_CROP)
        scale = chip_smoke.CONFIG5_SCALE
    frames, labels = (torch.as_tensor(a).cuda() for a in (frames, labels))
    state = create_train_state(model, OptimizerConfig(lr=lr, max_steps=1000))
    inner = make_train_step(model, state, loss_fn)
    # every model but FastSCNN trains on crops: its steps always augment
    augment = args.augment or args.model != "fastscnn"
    if augment:
        cfg = AugmentConfig(crop=crop, scale_range=scale,
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
    launches = sum(e.count for e in events) // args.steps
    print(f"step {wall_ms:.3f} ms (host clock); device busy {busy_ms:.3f} "
          f"ms a step (profiler), idle share {1 - busy_ms / wall_ms:.3f}; "
          f"{launches} kernel launches a step", flush=True)

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
    print(json.dumps({"model": args.model, "step_ms": wall_ms,
                      "device_busy_ms": busy_ms, "kernels": len(events),
                      "launches": launches, "augment": augment}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
