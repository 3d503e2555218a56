"""The halo exchanges and bytes a train step of `chip_smoke.py` phase 16
makes on each of its two H bands, counted on the CPU without ranks.

    python scripts/spatial_halo_plan.py [--models enet erfnet esnet ...]

For each band in turn, one process runs one train step's forward and
backward of phase 16's model (`chip_smoke.zoo_spatial_model`: bf16
compute, its loss) on that band of a batch of one image, `distributed`'s
layout patched to band r of 2 and its point-to-point exchange replaced by
one that counts what it would send and returns zeros. The image is cut to
the model's `max_stride` columns at the band's full rows, so every halo
has the rows it has on the card: the bytes scale with the batch and with
W (each level's width is the image's over its stride), and the script
prints them scaled to phase 16's batch and crop. Zeros in place of the
halo rows change the values, not the shapes.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402
from torch_semantic_segmentation_tpu_torch.parallel import (  # noqa: E402
    distributed)

BANDS = 2


def _exchange(sends: list, recvs: list, like: torch.Tensor) -> list:
    distributed.halo_exchanges += 1
    distributed.halo_bytes += sum(t.numel() * t.element_size()
                                  for t, _ in sends)
    return [torch.zeros(shape, dtype=like.dtype) for shape, _ in recvs]


def band_step(name: str, band: int) -> tuple[int, int, int]:
    """(exchanges, bytes sent, image columns) of one train step on `band`
    of BANDS, for one image of the model's crop rows and `max_stride`
    columns."""
    model, loss, _, _, _ = c.zoo_spatial_model(name, device="cpu")
    w = model.max_stride
    rows = c.ZS_CROP[name] // BANDS
    gen = torch.Generator().manual_seed(band)
    x = torch.randn(1, rows, w, 3, generator=gen).to(torch.bfloat16)
    y = torch.randint(0, c.NUM_CLASSES, (1, rows, w), generator=gen)
    patched = dict(is_spatial=lambda: True, num_spatial=lambda: BANDS,
                   spatial_rank=lambda: band, data_size=lambda: 1,
                   data_rank=lambda: 0, spatial_sum=lambda t: t,
                   _exchange=_exchange)
    saved = {k: getattr(distributed, k) for k in patched}
    for k, v in patched.items():
        setattr(distributed, k, v)
    h0, b0 = distributed.halo_exchanges, distributed.halo_bytes
    try:
        loss(model.train()(x), y).backward()
    finally:
        for k, v in saved.items():
            setattr(distributed, k, v)
    return (distributed.halo_exchanges - h0, distributed.halo_bytes - b0, w)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", nargs="+", default=list(c.ZS_STEPS),
                    choices=list(c.ZS_STEPS))
    args = ap.parse_args()
    torch.set_num_threads(2)
    for name in args.models:
        crop = c.ZS_CROP[name]
        for band in range(BANDS):
            n, sent, w = band_step(name, band)
            scale = c.ZS_BATCH * crop // w
            print(f"{name} band {band} of {BANDS} ({c.ZS_BATCH}x{crop // BANDS}"
                  f"x{crop}, bf16): {n} halo exchanges a step, "
                  f"{sent * scale} bytes sent ({sent} at 1x{crop // BANDS}"
                  f"x{w})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
