"""Inference CLI of the port (the JAX package's `cli/predict.py`): segment
image files with a trained model through the serving path.

  python -m torch_semantic_segmentation_tpu_torch.cli.predict \
      --model fastscnn --checkpoint ckpts --dataset cityscapes \
      --input frames/ --output-dir out --color

Writes `<stem>_ids.png` (class-id mask, 8-bit gray) per input image and,
with `--color`, `<stem>_color.png` coloured with the dataset palette.

Three parts: the files are read by the native codecs
(`native_loader.decode_image`, as the datasets read them); the frames in
memory go through `predict_frames`, which groups them by resolution,
compiles the predictor once for each group's shape (`serving.aot_compile`:
on the card one CUDA graph) and pads a group's tail batch by repeating its
last frame, so each batch has the group's one shape; the masks are written
by `write_png`, a PNG encoder over the standard library's zlib. The
predictor is `serving.make_predict_fn`: uint8 NHWC in, ids out,
normalisation on the device, BatchNorm folded, low-res logits resized
fused with the argmax.
"""

from __future__ import annotations

import argparse
import os
import struct
import typing as tp
import zlib

import numpy as np

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="fastscnn")
    p.add_argument("--dataset", default="cityscapes",
                   choices=["cityscapes", "camvid", "bdd", "mapillary",
                            "synthetic", "shapes"],
                   help="declares num_classes, normalization, and palette")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir or torch .pth (optional: random "
                        "init)")
    p.add_argument("--input", nargs="+", required=True,
                   help="image files and/or directories")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--color", action="store_true",
                   help="also write palette-colorized masks")
    p.add_argument("--no-fold-bn", dest="fold_bn", action="store_false",
                   help="keep BatchNorm unfolded (debug)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; raises "
                        "when there is none). Pass cpu for the CPU")
    return p.parse_args(argv)


def collect_images(inputs: list[str]) -> list[str]:
    """Expand files/directories into a sorted list of image paths."""
    paths: list[str] = []
    for item in inputs:
        if os.path.isdir(item):
            for name in sorted(os.listdir(item)):
                if name.lower().endswith(_IMG_EXTS):
                    paths.append(os.path.join(item, name))
        elif os.path.isfile(item):
            paths.append(item)
        else:
            raise FileNotFoundError(item)
    if not paths:
        raise FileNotFoundError(f"no images found under {inputs}")
    return paths


def auto_palette(num_classes: int) -> np.ndarray:
    """Deterministic fallback palette for datasets without official colors:
    evenly spaced hues at full saturation (class 0 kept dark)."""
    import colorsys
    out = np.zeros((num_classes, 3), np.uint8)
    for c in range(1, num_classes):
        r, g, b = colorsys.hsv_to_rgb((c - 1) / max(num_classes - 1, 1),
                                      0.85, 0.95)
        out[c] = (int(r * 255), int(g * 255), int(b * 255))
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path: str, image: np.ndarray):
    """Write a uint8 (H, W) array as an 8-bit gray PNG, or an (H, W, 3) one
    as RGB: IHDR, one IDAT of zlib-compressed rows (each row behind filter
    byte 0, none), IEND."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or not (
            image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"write_png takes uint8 (H, W) or (H, W, 3), got "
                         f"{image.dtype} {image.shape}")
    h, w = image.shape[:2]
    color_type = 0 if image.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                              color_type, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


def _groups(frames: tp.Sequence[np.ndarray]) -> dict[tuple[int, int],
                                                      list[int]]:
    """Frame indices by (H, W), in order of first sight."""
    groups: dict[tuple[int, int], list[int]] = {}
    for i, frame in enumerate(frames):
        groups.setdefault(tuple(frame.shape[:2]), []).append(i)
    return groups


def predict_frames(predict, frames: tp.Sequence[np.ndarray],
                   batch_size: int) -> list[np.ndarray]:
    """The (H, W) uint8 id map of each uint8 (H, W, 3) frame, in order.
    Frames of one resolution go through one `serving.aot_compile` of
    `predict` (from `make_predict_fn`) at (batch_size, H, W), in batches
    of `batch_size`, as the JAX CLI runs one compiled program per
    resolution; a group's tail batch is padded by repeating its last
    frame, so every batch of a group has the compiled shape. Each group's
    compiled predictor (on the card, its CUDA graph) is freed when the
    group is done."""
    from torch_semantic_segmentation_tpu_torch.serving import aot_compile

    out: list[np.ndarray | None] = [None] * len(frames)
    for (h, w), idxs in _groups(frames).items():
        compiled = aot_compile(predict, batch_size, h, w)
        for lo in range(0, len(idxs), batch_size):
            chunk = idxs[lo:lo + batch_size]
            batch = np.stack([frames[i] for i in chunk], axis=0)
            if len(chunk) < batch_size:
                pad = batch_size - len(chunk)
                batch = np.concatenate(
                    [batch, np.repeat(batch[-1:], pad, axis=0)], axis=0)
            ids = compiled(batch)[:len(chunk)].cpu().numpy()
            for j, i in enumerate(chunk):
                out[i] = ids[j]
        del compiled
    return out


def main(argv=None):
    from torch_semantic_segmentation_tpu_torch.cli.common import build_dataset
    from torch_semantic_segmentation_tpu_torch.cli.eval import load_weights
    from torch_semantic_segmentation_tpu_torch.data.native_loader import (
        decode_image)
    from torch_semantic_segmentation_tpu_torch.device import resolve_device
    from torch_semantic_segmentation_tpu_torch.models import get_model
    from torch_semantic_segmentation_tpu_torch.serving import make_predict_fn

    args = parse_args(argv)
    dev = resolve_device(args.device)
    bundle = build_dataset(args.dataset, None, "val") \
        if args.dataset in ("synthetic", "shapes") \
        else _bundle_meta_only(args.dataset)
    model = get_model(args.model, num_classes=bundle.num_classes, seed=0,
                      device=dev)
    load_weights(model, args.checkpoint)

    predict = make_predict_fn(model, fold_bn=args.fold_bn, mean=bundle.mean,
                              std=bundle.std, output="ids", device=dev)
    palette = bundle.palette if bundle.palette is not None \
        else auto_palette(bundle.num_classes)

    paths = collect_images(args.input)
    os.makedirs(args.output_dir, exist_ok=True)
    frames = [decode_image(path, 3) for path in paths]
    ids = predict_frames(predict, frames, args.batch_size)

    written = []
    for (h, w), idxs in sorted(_groups(frames).items()):
        for i in idxs:
            stem = os.path.splitext(os.path.basename(paths[i]))[0]
            id_path = os.path.join(args.output_dir, f"{stem}_ids.png")
            write_png(id_path, ids[i])
            written.append(id_path)
            if args.color:
                color_path = os.path.join(args.output_dir,
                                          f"{stem}_color.png")
                write_png(color_path, palette[ids[i]])
                written.append(color_path)
        print(f"{len(idxs)} frame(s) at {h}x{w} -> {args.output_dir}")
    return written


def _bundle_meta_only(name: str):
    """Dataset metadata (classes/palette/normalization) without requiring
    --dataset-dir: prediction needs no ground-truth files on disk."""
    from torch_semantic_segmentation_tpu_torch.cli.common import DatasetBundle
    from torch_semantic_segmentation_tpu_torch.data import camvid, cityscapes
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        CITYSCAPES_MEAN, CITYSCAPES_STD)

    if name in ("cityscapes", "bdd"):
        return DatasetBundle(
            dataset=None, num_classes=cityscapes.NUM_CLASSES,
            ignore_index=cityscapes.IGNORE_INDEX,
            class_names=cityscapes.CLASS_NAMES, label_lut=None,
            class_weights=None, mean=CITYSCAPES_MEAN, std=CITYSCAPES_STD,
            palette=cityscapes.PALETTE)
    if name == "camvid":
        return DatasetBundle(
            dataset=None, num_classes=camvid.NUM_CLASSES,
            ignore_index=camvid.IGNORE_INDEX,
            class_names=camvid.CLASS_NAMES, label_lut=None,
            class_weights=None, mean=CITYSCAPES_MEAN, std=CITYSCAPES_STD,
            palette=np.asarray(camvid.PALETTE, np.uint8))
    if name == "mapillary":
        # the v1.2 release has 66 classes; its colours live in the
        # dataset's config json, which prediction does not require: auto
        # palette instead
        return DatasetBundle(
            dataset=None, num_classes=66, ignore_index=65, class_names=(),
            label_lut=None, class_weights=None,
            mean=CITYSCAPES_MEAN, std=CITYSCAPES_STD, palette=None)
    raise ValueError(name)


def cli() -> int:
    """Console-script entry point (pyproject [project.scripts]): discard
    main()'s programmatic return value so setuptools' sys.exit() sees 0."""
    main()
    return 0


if __name__ == "__main__":
    main()
