"""Holds K2's backward (`ops.mbconv.expand_dw_backward`) against its plain
version on the very inputs FastSCNN's bf16 training step gives it, as
`chip_smoke.grad_check` does once, over many gradient passes, and shows
where the two part:

    python3 scripts/torch_mbconv_mask_probe.py [--root DIR] [--passes 15]

`--root` names the checkout whose port package runs (default: this one),
so that two commits can be compared on one card in one command. The model,
batches and optimizer are `chip_smoke.train`'s (b8 at 1024x2048); after
its 1 + `TRAIN_STEPS` steps, each pass records the nine K2 launches of one
forward and backward, and one more training step then moves the weights.

For each launch it prints the relative L2 error of dx, dW′, db′ and dk
against the plain version (`chip_smoke.check_recorded` fails above 2^-9);
the kernel's and the plain version's db′ against db′ summed in float64
under the mask of the exact pre-activation x·W′ + b′; how many elements a
float32 matmul of the pre-activation (cuBLAS's order) puts on the other
side of 0 from the exact one, and the largest |de| among them; and the
share of elements whose float32 pre-activation lies within the backward
kernel's error bound of 0 (KPAD 2^-20 |x_p| |W′_c|, `csrc/mbconv.cu`). Then
a summary and one JSON line. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def exact_analysis(mbconv, x, w, b, k, g, stride) -> dict:
    """db′ in float64 under the exact mask, the float32 matmul's sign flips
    and the share of elements within the kernel's bound of 0."""
    import torch
    n, h, wd, cin = x.shape
    ce = w.shape[1]
    ho, wo = mbconv._out_size(h, stride), mbconv._out_size(wd, stride)
    xb = x.to(torch.bfloat16).reshape(-1, cin)
    wb = w.to(torch.bfloat16)
    acc32 = xb.float() @ wb.float() + b.float()
    acc64 = xb.double() @ wb.double() + b.double()
    flip = (acc32 > 0) != (acc64 > 0)
    kpad = (cin + 31) // 32 * 32
    bound = (kpad / 2.0 ** 20) * xb.float().norm(dim=1, keepdim=True) \
        * wb.float().norm(dim=0, keepdim=True)
    near = float((acc32.abs() <= bound).double().mean())
    dep = torch.zeros((n, h + 2, wd + 2, ce), dtype=torch.float64,
                      device=x.device)
    gd, kd = g.double(), k.double()
    for dh, dw, win in mbconv._windows(dep, ho, wo, stride):
        win += gd * kd[dh, dw]
    de = dep[:, 1:h + 1, 1:wd + 1, :].reshape(-1, ce)
    db64 = (de * (acc64 > 0)).sum(dim=0)
    flipped = de[flip].abs()
    return dict(db64=db64, flips=int(flip.sum()),
                flip_de=float(flipped.max()) if flipped.numel() else 0.0,
                near=near)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--passes", type=int, default=15)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        normalize_batch)
    from torch_semantic_segmentation_tpu_torch.losses import (
        resize_cross_entropy_loss)
    from torch_semantic_segmentation_tpu_torch.models import get_model
    from torch_semantic_segmentation_tpu_torch.ops import mbconv
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)

    print(f"root {root}; device: {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {cs.smi_line()}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batches = []
    for seed in range(1 + cs.TRAIN_STEPS):
        f, lab = cs.make_batch(100 + seed)
        batches.append((normalize_batch(torch.from_numpy(f).cuda()),
                        torch.from_numpy(lab).cuda()))
    model = get_model("fastscnn", cs.NUM_CLASSES, upsample_logits=False,
                      compute_dtype=torch.bfloat16, seed=0, device="cuda")
    state = create_train_state(model, OptimizerConfig(lr=0.045,
                                                      max_steps=1000))
    step = make_train_step(model, state, resize_cross_entropy_loss)
    for batch in batches:
        step(*batch)

    names = ("dx", "dW", "db", "dk")
    rows = []
    for i in range(args.passes):
        calls = []
        model.train()
        model.zero_grad(set_to_none=True)
        model.dropout_generator.manual_seed(1234)
        images, labels = batches[i % len(batches)]
        with cs.swapped(cs.recording(calls)):
            resize_cross_entropy_loss(model(images), labels).backward()
        torch.cuda.synchronize()
        for key, fn, plain, inputs in calls:
            if key != "mbconv_bwd":
                continue
            with torch.no_grad():
                got, want = fn(*inputs), plain(*inputs)
                errs = {nm: cs.rel_l2(a, r)
                        for nm, a, r in zip(names, got, want)}
                ex = exact_analysis(mbconv, *inputs)
                row = {"pass": i, "shape": list(inputs[0].shape),
                       "ce": int(inputs[1].shape[1]), "stride": inputs[5],
                       **errs,
                       "db_kernel_vs_f64": cs.rel_l2(got[2], ex["db64"]),
                       "db_plain_vs_f64": cs.rel_l2(want[2], ex["db64"]),
                       "f32_flips": ex["flips"], "flip_de": ex["flip_de"],
                       "near_share": ex["near"]}
            rows.append(row)
            print(f"pass {i} x{tuple(row['shape'])} ce {row['ce']} "
                  f"s{row['stride']}: "
                  + " ".join(f"{nm} {errs[nm]:.3g}" for nm in names)
                  + f" | db vs f64: kernel {row['db_kernel_vs_f64']:.3g}, "
                  f"plain {row['db_plain_vs_f64']:.3g}; float32 matmul "
                  f"sign flips {row['f32_flips']} (largest |de| "
                  f"{row['flip_de']:.3g}); within the bound "
                  f"{row['near_share']:.3g}", flush=True)
        del calls
        step(*batches[(i + 3) % len(batches)])
        torch.cuda.synchronize()
    worst = np.array([max(r[nm] for nm in names) for r in rows])
    summary = dict(launches=len(rows), worst=float(worst.max()),
                   median=float(np.median(worst)),
                   over_2_9=int((worst > 2.0 ** -9).sum()),
                   over_1e_4=int((worst > 1e-4).sum()),
                   near_share_mean=float(np.mean([r["near_share"]
                                                  for r in rows])))
    print(f"{summary['launches']} launches: worst relative L2 "
          f"{summary['worst']:.3g} (median {summary['median']:.3g}); above "
          f"2^-9 {summary['over_2_9']}, above 1e-4 {summary['over_1e_4']}; "
          f"share within the bound {summary['near_share_mean']:.3g}",
          flush=True)
    print(json.dumps({"root": root, **summary, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
