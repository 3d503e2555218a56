"""The halo exchanges and bytes a train step of `chip_smoke.py` phase 15
or 16 makes on each of its two H bands, counted on the CPU without ranks.

    python scripts/spatial_halo_plan.py [--models enet erfnet esnet ...]
    python scripts/spatial_halo_plan.py --models fastscnn --remat
    python scripts/spatial_halo_plan.py --models fastscnn --rows 992
    python scripts/spatial_halo_plan.py --multiscale [--models bisenet icnet]
    python scripts/spatial_halo_plan.py --multiscale --models bisenet --rows 720

For each band in turn, one process runs one train step's forward and
backward of the phase's model (`chip_smoke.zoo_spatial_model`: bf16
compute, its loss; "fastscnn" is phase 15's, phase 6's model and loss)
on that band of a batch of one image, `distributed`'s layout patched to
band r of 2 and its point-to-point exchange replaced by one that counts
what it would send and returns zeros. The image is cut to the model's
`max_stride` columns at the band's full rows, so every halo has the rows
it has on the card: the bytes scale with the batch and with W (each
level's width is the image's over its stride), and the script prints
them scaled to the phase's batch and crop. Zeros in place of the halo
rows change the values, not the shapes.

`--rows H` splits an image of H rows as `parallel.shard_batch` does
(`distributed.split_rows` at the model's `max_stride`: 992 rows at 32 on
bands of 512 and 480), so each band's bytes are its own; the phase's
crop by default. `--remat` runs the step as `make_train_step(remat=True)`
does: each checkpointed segment's forward again in the backward, with
its halo exchanges.

With `--multiscale` it counts instead the halo exchanges of one call of
the multi-scale + flip eval step (`eval.make_multiscale_eval_step`,
scales 0.5 .. 1.75) on each band of a frame of `--rows` rows (1024 by
default), as phase 16 runs it (`chip_smoke.ZS_MULTISCALE`, `ZS_MS_HALOS`,
`ZS_MS_BDD_HALOS` at 720), at float32 compute and on 128 columns: the
fewest whose every scale the model's stride divides. A count of
exchanges depends on neither.
"""

from __future__ import annotations

import argparse
import contextlib
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


@contextlib.contextmanager
def on_band(band: int, split: tuple[int, ...] | None):
    """Within the block `distributed` runs as band `band` of BANDS of an
    image of `split`, with the counting exchange."""
    patched = dict(is_spatial=lambda: True, num_spatial=lambda: BANDS,
                   spatial_rank=lambda: band, data_size=lambda: 1,
                   data_rank=lambda: 0, spatial_sum=lambda t: t,
                   _exchange=_exchange, _split=split)
    saved = {k: getattr(distributed, k) for k in patched}
    for k, v in patched.items():
        setattr(distributed, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(distributed, k, v)


def phase_model(name: str, compute_dtype=None):
    """(model, loss, crop (H, W), batch) of phase 15's FastSCNN or phase
    16's `name`."""
    if name == "fastscnn":
        from torch_semantic_segmentation_tpu_torch.losses import (
            resize_cross_entropy_loss)
        from torch_semantic_segmentation_tpu_torch.models import get_model
        model = get_model("fastscnn", c.NUM_CLASSES, upsample_logits=False,
                          compute_dtype=compute_dtype or torch.bfloat16,
                          seed=0, device="cpu")
        return (model, resize_cross_entropy_loss, (c.SERVE_H, c.SERVE_W),
                c.SERVE_BATCH)
    model, loss, _, _, _ = c.zoo_spatial_model(name, device="cpu",
                                               compute_dtype=compute_dtype)
    return model, loss, c.zs_crop(name), c.ZS_BATCH


def band_step(name: str, band: int, rows: int | None = None,
              remat: bool = False) -> tuple[int, int, int, tuple]:
    """(exchanges, bytes sent, image columns, split) of one train step on
    `band` of BANDS of an image of `rows` rows (the phase's crop by
    default), for one image of the band's rows and `max_stride`
    columns."""
    from torch_semantic_segmentation_tpu_torch.train import _checkpointed
    model, loss, (h, _), _ = phase_model(name)
    w = model.max_stride
    split = distributed.split_rows(rows or h, BANDS, w)
    gen = torch.Generator().manual_seed(band)
    x = torch.randn(1, split[band], w, 3, generator=gen).to(torch.bfloat16)
    y = torch.randint(0, c.NUM_CLASSES, (1, split[band], w), generator=gen)
    h0, b0 = distributed.halo_exchanges, distributed.halo_bytes
    with on_band(band, split):
        with _checkpointed(model) if remat else contextlib.nullcontext():
            out = model.train()(x)
        loss(out, y).backward()
    return (distributed.halo_exchanges - h0, distributed.halo_bytes - b0, w,
            split)


def band_multiscale(name: str, band: int, rows: int = 1024) -> int:
    """The halo exchanges of one multi-scale + flip call on `band` of
    BANDS of a frame of `rows` x 128."""
    from torch_semantic_segmentation_tpu_torch.eval import (
        make_multiscale_eval_step)
    model, _, _, _ = phase_model(name, compute_dtype=torch.float32)
    split = distributed.split_rows(rows, BANDS, model.max_stride)
    gen = torch.Generator().manual_seed(band)
    x = torch.randn(1, split[band], 128, 3, generator=gen)
    y = torch.randint(0, c.NUM_CLASSES, (1, split[band], 128), generator=gen)
    step = make_multiscale_eval_step(model, num_classes=c.NUM_CLASSES,
                                     device="cpu")
    h0 = distributed.halo_exchanges
    with on_band(band, split):
        step(torch.zeros(c.NUM_CLASSES, c.NUM_CLASSES, dtype=torch.int64),
             x, y)
    return distributed.halo_exchanges - h0


def main() -> int:
    names = ["fastscnn", *c.ZS_STEPS]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", nargs="+", default=list(c.ZS_STEPS),
                    choices=names)
    ap.add_argument("--rows", type=int, default=None,
                    help="the image's rows (the phase's crop by default)")
    ap.add_argument("--remat", action="store_true",
                    help="count a remat step's exchanges")
    ap.add_argument("--multiscale", action="store_true",
                    help="count a multi-scale eval call's exchanges")
    args = ap.parse_args()
    torch.set_num_threads(2)
    if args.multiscale:
        rows = args.rows or 1024
        for name in args.models:
            for band in range(BANDS):
                print(f"{name} band {band} of {BANDS} ({rows} rows): "
                      f"{band_multiscale(name, band, rows)} halo exchanges "
                      f"a multi-scale + flip call", flush=True)
        return 0
    for name in args.models:
        _, _, (h, cw), batch = phase_model(name)
        for band in range(BANDS):
            n, sent, w, split = band_step(name, band, args.rows, args.remat)
            scale = batch * cw // w
            print(f"{name} band {band} of {BANDS} ({batch}x{split[band]}x"
                  f"{cw} of {sum(split)} rows split {split}, bf16"
                  f"{', remat' if args.remat else ''}): {n} halo exchanges "
                  f"a step, {sent * scale} bytes sent ({sent} at "
                  f"1x{split[band]}x{w})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
