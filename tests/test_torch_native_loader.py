"""PyTorch port, its own binding of the native C++ loader
(`data/native_loader.py`) on the CPU:

- its `NativeBatchLoader` equals the JAX package's byte for byte on the
  same files, seed, `start_batch` and `sample_slice` (the same C++, built
  and bound separately);
- `decode_image` equals cv2 on PNG, RGB and gray;
- `native_batch_iterator` over `CityscapesDataset` with the LUT equals
  `batch_iterator` on the same dataset with `shuffle=False`, and
  `train_input_pipeline(native=True)` yields its augmented batches;
- the library lands in the port's `_build/` under a hash of the source
  and flags, is reused on a second call, and a failed build raises with
  the compiler's output;
- `out=` writes a batch into given tensors."""

import os
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu.data import native_loader as jnative
from torch_semantic_segmentation_tpu_torch.data import native_loader as native
from torch_semantic_segmentation_tpu_torch.data import pipeline
from torch_semantic_segmentation_tpu_torch.data.cityscapes import (
    CityscapesDataset, label_lookup_table)
from torch_semantic_segmentation_tpu_torch.data.transforms import (
    AugmentConfig, augment_batch)

torch.set_num_threads(2)

H, W = 20, 30


@pytest.fixture
def city(tmp_path):
    """Seven Cityscapes-layout pairs: noise images, raw-id masks; the
    last pair at another size (the loader resizes it)."""
    rng = np.random.default_rng(0)
    for i in range(7):
        h, w = (H, W) if i < 6 else (H + 6, W - 4)
        name = f"c{i // 4}_{i:06d}_000019"
        d_img = tmp_path / "leftImg8bit" / "train" / f"c{i // 4}"
        d_lbl = tmp_path / "gtFine" / "train" / f"c{i // 4}"
        d_img.mkdir(parents=True, exist_ok=True)
        d_lbl.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(d_img / f"{name}_leftImg8bit.png"),
                    rng.integers(0, 256, (h, w, 3), np.uint8))
        cv2.imwrite(str(d_lbl / f"{name}_gtFine_labelIds.png"),
                    rng.integers(0, 34, (h, w), np.uint8))
    return CityscapesDataset(str(tmp_path))


def test_decode_png_matches_cv2(city):
    got = native.decode_image(city.image_paths[0], 3)
    want = cv2.cvtColor(cv2.imread(city.image_paths[0], cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)
    assert got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        native.decode_image(city.label_paths[0], 1),
        cv2.imread(city.label_paths[0], cv2.IMREAD_GRAYSCALE))
    with pytest.raises(IOError, match="native decode failed"):
        native.decode_image(city.image_paths[0] + ".missing.png")


@pytest.mark.parametrize("kw", [
    dict(seed=0),
    dict(seed=9, start_batch=4),
    dict(seed=2, sample_slice=(1, 3), label_lut=True),
    dict(seed=5, shuffle=False, label_lut=True, start_batch=2),
], ids=["seed0", "start_batch", "slice_lut", "no_shuffle"])
def test_loader_equals_jax_byte_for_byte(city, kw):
    kw = dict(kw)
    if kw.pop("label_lut", False):
        kw["label_lut"] = label_lookup_table()
    args = (city.image_paths, city.label_paths, 3, H, W)
    port = native.NativeBatchLoader(*args, num_threads=3, epochs=3, **kw)
    ref = jnative.NativeBatchLoader(*args, num_threads=3, epochs=3, **kw)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 6 - kw.get("start_batch", 0)
    for (gi, gl), (ri, rl) in zip(got, want):
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gl, rl)
    port.close()
    ref.close()


def test_native_stream_equals_batch_iterator_unshuffled(city):
    lut = label_lookup_table()
    nat = native.native_batch_iterator(city, 2, shuffle=False, epochs=1,
                                       label_lut=lut, num_threads=4)
    assert nat.batch_shapes == ((2, H, W, 3), (2, H, W))
    py = pipeline.batch_iterator(city, 2, shuffle=False, epochs=1,
                                 label_lut=lut)
    for k, ((ni, nl), (pi, pl)) in enumerate(zip(nat, py)):
        np.testing.assert_array_equal(ni, pi)
        np.testing.assert_array_equal(nl, pl)
        raw = np.stack([city[2 * k + j][1] for j in range(2)])
        np.testing.assert_array_equal(nl, lut[raw])
    assert k == 2


def test_train_input_pipeline_native_on_the_cpu(city):
    cfg = AugmentConfig(crop=(16, 24))
    gen = torch.Generator().manual_seed(3)
    got = list(pipeline.train_input_pipeline(
        city, 2, cfg, generator=gen, label_lut=label_lookup_table(),
        device="cpu", native=True, seed=1, epochs=1, num_threads=2))
    host = native.native_batch_iterator(city, 2, seed=1, epochs=1,
                                        label_lut=label_lookup_table())
    ref = torch.Generator().manual_seed(3)
    assert len(got) == 3
    for (images, labels), (hi, hl) in zip(got, host):
        want = augment_batch(torch.from_numpy(hi), torch.from_numpy(hl), ref,
                             cfg)
        assert torch.equal(images, want[0]) and torch.equal(labels, want[1])


def test_out_writes_into_given_tensors(city):
    loader = native.NativeBatchLoader(city.image_paths, city.label_paths, 2,
                                      H, W, shuffle=False, epochs=1)
    out = (torch.zeros((2, H, W, 3), dtype=torch.uint8),
           torch.zeros((2, H, W), dtype=torch.uint8))
    images, labels = loader.__next__(out=out)
    assert images is out[0] and labels is out[1]
    np.testing.assert_array_equal(images[0].numpy(), city[0][0])
    with pytest.raises(ValueError, match="shapes"):
        loader.__next__(out=(out[0][:1], out[1][:1]))
    with pytest.raises(ValueError, match="contiguous"):
        loader.__next__(out=(
            torch.zeros((2, W, H, 3), dtype=torch.uint8).transpose(1, 2),
            out[1]))
    loader.close()


def test_missing_file_raises_in_next(city, tmp_path):
    paths = list(city.image_paths)
    paths[0] = str(tmp_path / "gone.png")
    loader = native.NativeBatchLoader(paths, city.label_paths, 2, H, W,
                                      shuffle=False, epochs=1)
    with pytest.raises(IOError, match="failed to decode image"):
        next(loader)
    loader.close()


def test_library_is_built_once_under_the_source_hash():
    first = native.build()
    assert first == native.library_path()
    assert first.parent == Path(native.__file__).resolve().parent.parent / "_build"
    assert first.name.startswith("libtpu_seg_loader-")
    stamp = os.stat(first)
    assert native.build() == first
    again = os.stat(first)
    assert (again.st_ino, again.st_mtime_ns) == (stamp.st_ino,
                                                 stamp.st_mtime_ns)
    assert native.native_available()


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    src = tmp_path / "tpu_seg_loader.cpp"
    shutil.copy(native.SOURCE, src)
    with open(src, "a") as f:
        f.write("\nint broken( {\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        native.build()
    assert list((tmp_path / "_build").iterdir()) == []
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()
