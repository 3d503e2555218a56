"""CPU rehearsal of `chip_smoke.py` phase 16 (the zoo on two H bands) at a
tiny size, without a card.

    python scripts/torch_spatial_rehearsal.py [--crop 64|128]
        [--models deeplab unet enet erfnet esnet bisenet icnet lednet
                  contextnet]
        [--sensitivity]

Runs `chip_smoke.zoo_spatial_phase` itself, in float32 on CPU gloo ranks,
for every model of its `ZS_STEPS` or those named, with its setup cut
down: DeepLab-R50, UNet (base 16), and ENet, ERFNet, ESNet, BiSeNet-R18,
ICNet-R50, LEDNet and ContextNet at full width, on 4 frames of 128x256
(crop 64; 256x256 for crop 128) cut to crop x crop, the loss casting
DeepLab's, BiSeNet's and ICNet's logits to bf16 so that K3's plain
version runs on each band, and LEDNet's and ContextNet's so that K1's
does, `torch.cuda.Event` and the memory calls stubbed, and every kernel
wrapper counting its calls as launches (the CPU runs the plain
versions). LEDNet's 1/64 needs crop 128 on two bands. ContextNet's K2
and K6 take bf16 compute only, so in float32 its step and eval expect
neither (bf16 on the CPU makes the FFM's dilated depthwise conv's weight
gradient unstable). It prints phase 16's lines and stops at the first
bar a reading misses, as the phase does on the card. In float32 the nudges move BiSeNet's step-1
gradient by 7.3e-5 only, where the bands' bf16 sums of K3's cotangent
at the halo rows move it 1.08e-3, so BiSeNet misses its gradient bar
here; on the card, in bf16, the nudges' 0.19 sits beside the bands'
0.21 (PERF.md §6).

`--sensitivity` prints instead how far DeepLab's step-1 gradient (relative
L2 over the tree) and loss move in this process when the batch means of
one group of BNs are moved up one float32 step (`chip_smoke.
nudged_moments`, one group at a time): where the step's noise comes from.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402
from torch_semantic_segmentation_tpu_torch.parallel import (  # noqa: E402
    distributed)

GROUPS = ("backbone.stem", "backbone.stage1", "backbone.stage2",
          "backbone.stage3", "backbone.stage4", "aspp.conv1", "aspp.atrous",
          "aspp.image_pool", "aspp.project")


class _Event:
    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def patch(crop: int, models=None) -> None:
    """Cut phase 16 down to `crop` on the CPU, to `models` where they are
    named (see the module's doc)."""
    if models:
        c.ZS_STEPS = {m: c.ZS_STEPS[m] for m in models}
    torch.set_num_threads(2)
    torch.cuda.Event = _Event
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    for _, mod, name, _ in c.train_wrappers():
        def counting(*args, _fn=getattr(mod, name), _mod=mod, _name=name):
            getattr(_mod, _name).launches += 1
            return _fn(*args)
        counting.launches = 0
        setattr(mod, name, counting)
    blocks = crop // 16

    def small_batch(seed: int):
        rng = np.random.default_rng(seed)
        base = rng.integers(0, 256, (8, blocks, 8, 3), dtype=np.int16)
        frames = np.repeat(np.repeat(base, 32, axis=1), 32, axis=2)
        frames += rng.integers(-24, 25, frames.shape, dtype=np.int16)
        classes = (base[..., 0] // 64) * 4 + base[..., 1] // 64
        labels = np.repeat(np.repeat(classes, 32, axis=1), 32, axis=2)
        labels[:, :8] = 255
        return (np.clip(frames, 0, 255).astype(np.uint8),
                labels.astype(np.uint8))

    def setup(name: str):
        from torch_semantic_segmentation_tpu_torch.data.transforms import (
            AugmentConfig)
        from torch_semantic_segmentation_tpu_torch.losses import (
            cross_entropy_loss, resize_ohem_cross_entropy)
        from torch_semantic_segmentation_tpu_torch.models import get_model
        if name not in ("deeplab", "unet"):
            model, loss, cfg, lr, seed = c.zoo_spatial_model(
                name, device="cpu", compute_dtype=torch.float32)
            if name in dict(c.CONFIG5_MODELS):
                def loss(outs, y, _config5=loss):
                    return _config5([o.to(torch.bfloat16) for o in outs], y)
            if name in c.STRETCH_LOW_RES:
                def loss(logits, y, _resize_ce=loss):
                    return _resize_ce(logits.to(torch.bfloat16), y)
            cfg = dataclasses.replace(cfg, crop=(crop, crop),
                                      out_dtype=torch.float32)
            frames, labels = small_batch(seed)
            return (model, torch.from_numpy(frames[:c.ZS_BATCH]),
                    torch.from_numpy(labels[:c.ZS_BATCH]), cfg, loss, lr)
        frames, labels = small_batch(600 if name == "deeplab" else 500)
        if name == "deeplab":
            model = get_model("deeplabv3_resnet50", c.NUM_CLASSES,
                              upsample_logits=False, seed=0, device="cpu")
            cfg = AugmentConfig(crop=(crop, crop), scale_range=(0.5, 2.0))

            def loss(logits, y):
                return resize_ohem_cross_entropy(
                    logits.to(torch.bfloat16), y, thresh=c.OHEM_THRESH,
                    min_kept=5000)
            lr = c.DEEPLAB_LR
        else:
            model = get_model("unet", c.NUM_CLASSES, base_ch=16,
                              upsample="bilinear", seed=0, device="cpu")
            cfg = AugmentConfig(crop=(crop, crop))
            loss, lr = cross_entropy_loss, c.UNET_LR
        return (model, torch.from_numpy(frames[:c.ZS_BATCH]),
                torch.from_numpy(labels[:c.ZS_BATCH]), cfg, loss, lr)

    real_per_step = c.per_step

    def per_step(steps: int, model: str = "fastscnn") -> dict:
        counts = real_per_step(steps, model)
        if model == "contextnet":        # float32: no K2 (nor K6 below)
            counts.update(mbconv_fwd=0, mbconv_bwd=0)
        return counts

    c.per_step = per_step
    c.ZS_K6 = {"contextnet": (0, 0)}
    c.make_batch = small_batch
    c.zoo_spatial_setup = setup
    init = distributed.initialize
    distributed.initialize = lambda *a, **k: init("cpu", **k)
    c.ZS_RANK_SCRIPT = (
        f"import sys\nsys.path.insert(0, {os.path.dirname(__file__)!r})\n"
        f"import torch_spatial_rehearsal as r\nr.patch({crop}, {models!r})\n"
        "import chip_smoke\nchip_smoke.zoo_spatial_rank()\n")


def sensitivity() -> None:
    from torch_semantic_segmentation_tpu_torch.ops import conv
    real, forward = conv.batch_moments, conv.BatchNorm2d.forward
    setup, names, current = c.zoo_spatial_setup, {}, [""]

    def naming_setup(name: str):
        out = setup(name)
        names.clear()
        names.update({id(m): n for n, m in out[0].named_modules()})
        return out

    c.zoo_spatial_setup = naming_setup
    base = c.zoo_spatial_run("deeplab", sharded=False, steps=1)[1]
    print(f"DeepLab step 1: loss {base['losses'][0]:.6f}", flush=True)
    for group in GROUPS:
        def named(self, x):
            current[0] = names.get(id(self), "")
            return forward(self, x)

        def moments(x, dims, _group=group):
            mean, sq = real(x, dims)
            if current[0].startswith(_group):   # as `c.nudged_moments`
                m = mean.detach()
                mean = mean + (torch.nextafter(
                    m, torch.full_like(m, np.inf)) - m)
            return mean, sq

        conv.BatchNorm2d.forward, conv.batch_moments = named, moments
        try:
            res = c.zoo_spatial_run("deeplab", sharded=False, steps=1)[1]
        finally:
            conv.BatchNorm2d.forward, conv.batch_moments = forward, real
        print(f"{group}: gradient {c.rel_tree(res['grads'], base['grads']):.4g}"
              f", loss {abs(res['losses'][0] / base['losses'][0] - 1):.3g}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--crop", type=int, default=64, choices=(64, 128))
    ap.add_argument("--models", nargs="+", choices=list(c.ZS_STEPS))
    ap.add_argument("--sensitivity", action="store_true")
    args = ap.parse_args()
    patch(args.crop, args.models)
    if args.sensitivity:
        sensitivity()
    else:
        c.zoo_spatial_phase()
    return 0


if __name__ == "__main__":
    sys.exit(main())
