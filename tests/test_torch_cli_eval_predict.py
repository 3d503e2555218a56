"""PyTorch port, the eval and predict CLIs (`cli/eval.py`,
`cli/predict.py`) on the CPU against the JAX package's, both loading one
`.pth` written from the JAX FastSCNN (19 classes, BN statistics set from
the eval frames by `calibrate_bn`, so that the ids vary):

- eval on `--dataset synthetic --max-batches 1`, single-scale (at
  `--eval-size 64 128`) and multi-scale (scales 0.5 and 1.0, with flip, at
  the native 128x256): per-class IoU within 1e-3 (an argmax tie moves one
  pixel, 1.5e-5 of a class's 65,536; the measured gap is 0 on both) and
  the same classes without support;
- predict on the same PNG files (written by cv2; two resolutions, a
  padded tail batch): the id masks equal except at most 1e-3 of the pixels
  (measured: 0), every `_color.png` equals `palette[ids]`;
- the port's eval on a checkpoint directory of its train CLI: restored,
  an empty directory raises `FileNotFoundError`, a wrong model raises
  naming the key;
- `collect_images`, `auto_palette` and `_bundle_meta_only` equal JAX's;
- `write_png`'s files, read by cv2, equal the arrays (gray and RGB, odd
  widths), and other arrays are refused."""

import os

import cv2
import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu.cli import eval as jeval_cli
from torch_semantic_segmentation_tpu.cli import predict as jpredict_cli
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu_torch.cli import eval as eval_cli
from torch_semantic_segmentation_tpu_torch.cli import predict as predict_cli
from torch_semantic_segmentation_tpu_torch.cli.train import main as train
from torch_semantic_segmentation_tpu_torch.data.synthetic import (
    synthetic_uint8_batch)
from torch_semantic_segmentation_tpu_torch.data.transforms import (
    CITYSCAPES_MEAN, CITYSCAPES_STD)

from tests.torch_port_util import calibrate_bn, jax_zoo_model

torch.set_num_threads(2)

IOU_TOL = 1e-3
PIXEL_SHARE = 1e-3


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """The JAX FastSCNN's weights as a torch file, its BN statistics from
    the first two frames the eval CLI reads."""
    jmodel = jax_zoo_model("fastscnn", 19, seed=3)
    frames, _ = synthetic_uint8_batch(16, 128, 256, 19, seed=0)
    x = ((frames[:2] / 255.0 - np.asarray(CITYSCAPES_MEAN))
         / np.asarray(CITYSCAPES_STD)).astype(np.float32)
    calibrate_bn(jmodel, x)
    path = str(tmp_path_factory.mktemp("weights") / "fastscnn.pth")
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in export_torch_state_dict(jmodel).items()}, path)
    return path


@pytest.mark.parametrize("extra", [
    ["--eval-size", "64", "128"],
    ["--multi-scale", "--scales", "0.5", "1.0"]], ids=["single", "multi"])
def test_eval_cli_equals_jax(pth, extra):
    argv = ["--dataset", "synthetic", "--model", "fastscnn", "--batch-size",
            "2", "--max-batches", "1", "--checkpoint", pth, *extra]
    want_iou, want_miou = jeval_cli.main(argv)
    got_iou, got_miou = eval_cli.main(argv + ["--device", "cpu"])
    want_iou = np.asarray(want_iou, np.float64)
    assert got_iou.shape == want_iou.shape == (19,)
    np.testing.assert_array_equal(np.isnan(got_iou), np.isnan(want_iou))
    assert np.nanmax(np.abs(got_iou - want_iou)) <= IOU_TOL
    assert abs(got_miou - float(want_miou)) <= IOU_TOL
    assert np.nansum(want_iou) > 0


def _frames(tmp_path):
    """Three 64x64 frames (batch 2: a padded tail of 1) and one 64x96 (a
    second group), smooth colour blocks with noise."""
    rng = np.random.default_rng(4)
    d = tmp_path / "frames"
    d.mkdir()
    for name, (h, w) in (("s0", (64, 64)), ("s1", (64, 64)),
                         ("s2", (64, 64)), ("wide", (64, 96))):
        blocks = rng.integers(0, 256, (h // 16, w // 16, 3))
        img = np.repeat(np.repeat(blocks, 16, 0), 16, 1)
        img = np.clip(img + rng.integers(-20, 21, img.shape), 0, 255)
        assert cv2.imwrite(str(d / f"{name}.png"), img.astype(np.uint8))
    return d


def test_predict_cli_equals_jax(pth, tmp_path):
    d = _frames(tmp_path)
    argv = ["--model", "fastscnn", "--dataset", "cityscapes", "--checkpoint",
            pth, "--input", str(d), "--batch-size", "2", "--color"]
    want = jpredict_cli.main(argv + ["--output-dir", str(tmp_path / "jax")])
    got = predict_cli.main(argv + ["--output-dir", str(tmp_path / "port"),
                                   "--device", "cpu"])
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert len(got) == 8
    from torch_semantic_segmentation_tpu_torch.data import cityscapes
    differ = total = 0
    for name in ("s0", "s1", "s2", "wide"):
        ids = cv2.imread(str(tmp_path / "port" / f"{name}_ids.png"),
                         cv2.IMREAD_UNCHANGED)
        ref = cv2.imread(str(tmp_path / "jax" / f"{name}_ids.png"),
                         cv2.IMREAD_UNCHANGED)
        assert ids.dtype == np.uint8 and ids.shape == ref.shape
        differ += int((ids != ref).sum())
        total += ids.size
        color = cv2.cvtColor(cv2.imread(
            str(tmp_path / "port" / f"{name}_color.png")), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(color, cityscapes.PALETTE[ids])
    assert differ <= PIXEL_SHARE * total
    assert len(np.unique(ids)) > 1


def test_eval_cli_on_a_train_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ck")
    train(["--device", "cpu", "--no-bf16", "--dataset", "synthetic",
           "--model", "fastscnn", "--batch-size", "2", "--crop-size", "64",
           "--max-iterations", "2", "--log-every", "1",
           "--checkpoint-dir", ckpt, "--checkpoint-every", "1"])
    base = ["--device", "cpu", "--dataset", "synthetic", "--batch-size", "2",
            "--max-batches", "1", "--eval-size", "64", "128"]
    iou, miou = eval_cli.main(base + ["--model", "fastscnn",
                                      "--checkpoint", ckpt])
    assert iou.shape == (19,) and np.isfinite(miou)
    with pytest.raises(KeyError, match="wrong model"):
        eval_cli.main(base + ["--model", "enet", "--checkpoint", ckpt])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        eval_cli.main(base + ["--model", "fastscnn", "--checkpoint",
                              str(empty)])


def test_collect_images_equals_jax(tmp_path):
    d = _frames(tmp_path)
    (d / "notes.txt").write_text("not an image")
    (d / "b.JPG").write_bytes(b"")
    for inputs in ([str(d)], [str(d / "wide.png"), str(d)]):
        assert predict_cli.collect_images(inputs) == \
            jpredict_cli.collect_images(inputs)
    for inputs in ([str(d / "missing.png")], [str(tmp_path / "none")]):
        with pytest.raises(FileNotFoundError):
            jpredict_cli.collect_images(inputs)
        with pytest.raises(FileNotFoundError):
            predict_cli.collect_images(inputs)
    (tmp_path / "void").mkdir()
    with pytest.raises(FileNotFoundError, match="no images"):
        predict_cli.collect_images([str(tmp_path / "void")])


@pytest.mark.parametrize("n", [1, 2, 4, 19, 66])
def test_auto_palette_equals_jax(n):
    got = predict_cli.auto_palette(n)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jpredict_cli.auto_palette(n))


@pytest.mark.parametrize("name", ["cityscapes", "bdd", "camvid", "mapillary"])
def test_bundle_meta_only_equals_jax(name):
    got = predict_cli._bundle_meta_only(name)
    want = jpredict_cli._bundle_meta_only(name)
    for field in ("dataset", "num_classes", "ignore_index", "class_names",
                  "label_lut", "class_weights", "mean", "std"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.palette is None) == (want.palette is None)
    if want.palette is not None:
        assert got.palette.dtype == np.asarray(want.palette).dtype
        np.testing.assert_array_equal(got.palette, want.palette)
    with pytest.raises(ValueError):
        predict_cli._bundle_meta_only("synthetic")


@pytest.mark.parametrize("shape", [(7, 13), (1, 1), (5, 31, 3), (16, 9, 3)])
def test_write_png_reads_back_in_cv2(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    path = str(tmp_path / "x.png")
    predict_cli.write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        back = cv2.cvtColor(back, cv2.COLOR_BGR2RGB)
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, img)


@pytest.mark.parametrize("bad", [np.zeros((4, 4), np.int32),
                                 np.zeros((4, 4, 4), np.uint8),
                                 np.zeros((4,), np.uint8)])
def test_write_png_refuses_other_arrays(tmp_path, bad):
    with pytest.raises(ValueError, match="write_png"):
        predict_cli.write_png(str(tmp_path / "x.png"), bad)
