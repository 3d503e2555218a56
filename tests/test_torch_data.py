"""PyTorch port, the datasets (`data/{cityscapes,camvid,bdd,mapillary,
synthetic}.py`) against the JAX package's, on trees written to `tmp_path`
in the process (cv2 writes the images and masks, PIL Mapillary's palette
masks):

- `image_paths`, `label_paths` and `len` equal;
- every PNG decodes to the JAX package's array exactly (the port's
  libpng against its cv2, and against its PIL for palette masks);
- JPEG (BDD's and Mapillary's images): libjpeg against cv2's decoder. The
  bound measured on these files (random and smooth content, quality 75-100,
  odd sizes) is 0 levels: both decode with the same IDCT, so the test
  holds the arrays equal;
- the tables and helpers (`label_lookup_table`, `encode_labels`,
  `enet_class_weights`, `rgb_mask_to_index`, Mapillary's LUT and class
  list) and the synthetic data (`synthetic_batch`, `synthetic_uint8_batch`,
  `ShapesDataset[i]`) equal the JAX package's."""

import json
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from torch_semantic_segmentation_tpu.data import bdd as jbdd
from torch_semantic_segmentation_tpu.data import camvid as jcamvid
from torch_semantic_segmentation_tpu.data import cityscapes as jcity
from torch_semantic_segmentation_tpu.data import mapillary as jmap
from torch_semantic_segmentation_tpu.data import synthetic as jsyn
from torch_semantic_segmentation_tpu_torch.data import bdd, camvid, cityscapes
from torch_semantic_segmentation_tpu_torch.data import mapillary, synthetic

H, W = 24, 40


def _image(rng, h=H, w=W):
    """Smooth colour ramps with noise: both JPEG's flat and busy blocks."""
    ys, xs = np.mgrid[0:h, 0:w]
    base = np.stack([ys * 5, xs * 3, (ys + xs) * 2], -1)
    return np.clip(base + rng.integers(-40, 41, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _write_rgb(path, rgb, **kw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    assert cv2.imwrite(str(path), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR), *kw.values())


def _write_gray(path, mask):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    assert cv2.imwrite(str(path), mask)


def _same_dataset(port, ref):
    assert port.image_paths == ref.image_paths
    assert port.label_paths == ref.label_paths
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        (pi, pl), (ri, rl) = port[i], ref[i]
        assert pi.dtype == ri.dtype == np.uint8 and pl.dtype == rl.dtype
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pl, rl)


@pytest.fixture
def cityscapes_root(tmp_path):
    rng = np.random.default_rng(0)
    for city, names in (("aachen", ("aachen_000000_000019",
                                     "aachen_000001_000019")),
                        ("bochum", ("bochum_000000_000313",))):
        for name in names:
            _write_rgb(tmp_path / "leftImg8bit" / "train" / city
                       / f"{name}_leftImg8bit.png", _image(rng))
            _write_gray(tmp_path / "gtFine" / "train" / city
                        / f"{name}_gtFine_labelIds.png",
                        rng.integers(0, 34, (H, W), np.uint8))
    return tmp_path


def test_cityscapes_dataset_equals_jax(cityscapes_root):
    _same_dataset(cityscapes.CityscapesDataset(str(cityscapes_root)),
                  jcity.CityscapesDataset(str(cityscapes_root)))
    assert len(cityscapes.CityscapesDataset(str(cityscapes_root), "val")) == 0


def test_cityscapes_missing_label_raises(cityscapes_root):
    os.remove(cityscapes.CityscapesDataset(str(cityscapes_root)).label_paths[1])
    with pytest.raises(FileNotFoundError, match="gtFine"):
        cityscapes.CityscapesDataset(str(cityscapes_root))


def test_cityscapes_tables_equal_jax():
    np.testing.assert_array_equal(cityscapes.label_lookup_table(),
                                  jcity.label_lookup_table())
    raw = np.random.default_rng(1).integers(0, 256, (7, 9), np.uint8)
    np.testing.assert_array_equal(cityscapes.encode_labels(raw),
                                  jcity.encode_labels(raw))
    np.testing.assert_array_equal(cityscapes.enet_class_weights(),
                                  jcity.enet_class_weights())
    freq = np.linspace(0.01, 0.2, 19)
    np.testing.assert_array_equal(cityscapes.enet_class_weights(freq, 1.1),
                                  jcity.enet_class_weights(freq, 1.1))
    np.testing.assert_array_equal(cityscapes.PALETTE, jcity.PALETTE)
    assert cityscapes.CLASS_NAMES == jcity.CLASS_NAMES
    assert (cityscapes.NUM_CLASSES, cityscapes.IGNORE_INDEX) == (
        jcity.NUM_CLASSES, jcity.IGNORE_INDEX)


@pytest.mark.parametrize("layout", ["index", "rgb"])
def test_camvid_dataset_equals_jax(tmp_path, layout):
    rng = np.random.default_rng(2)
    for i in range(3):
        img = _image(rng)
        if layout == "index":     # SegNet layout, 11 = void
            _write_rgb(tmp_path / "train" / f"f{i}.png", img)
            _write_gray(tmp_path / "trainannot" / f"f{i}.png",
                        rng.integers(0, 12, (H, W), np.uint8))
        else:                     # RGB masks, some colours off the palette
            idx = rng.integers(0, 12, (H, W))
            colors = np.concatenate([camvid.PALETTE, [[1, 2, 3]]]).astype(
                np.uint8)
            _write_rgb(tmp_path / "images" / "train" / f"f{i}.png", img)
            _write_rgb(tmp_path / "labels" / "train" / f"f{i}_L.png",
                       colors[idx])
    port = camvid.CamVidDataset(str(tmp_path))
    assert port.rgb_masks == (layout == "rgb")
    _same_dataset(port, jcamvid.CamVidDataset(str(tmp_path)))
    labels = np.concatenate([port[i][1] for i in range(len(port))])
    assert set(np.unique(labels)) <= set(range(11)) | {255}
    assert 255 in labels


def test_camvid_tables_equal_jax():
    rng = np.random.default_rng(3)
    colors = np.concatenate([camvid.PALETTE, [[9, 9, 9]]]).astype(np.uint8)
    mask = colors[rng.integers(0, 12, (13, 17))]
    np.testing.assert_array_equal(camvid.rgb_mask_to_index(mask),
                                  jcamvid.rgb_mask_to_index(mask))
    np.testing.assert_array_equal(camvid.enet_class_weights(),
                                  jcamvid.enet_class_weights())
    np.testing.assert_array_equal(camvid.PALETTE, jcamvid.PALETTE)
    assert camvid.CLASS_NAMES == jcamvid.CLASS_NAMES


@pytest.mark.parametrize("layout", ["10k", "seg"])
def test_bdd_dataset_equals_jax(tmp_path, layout):
    rng = np.random.default_rng(4)
    if layout == "10k":
        img_dir = tmp_path / "images" / "10k" / "train"
        lbl_dir = tmp_path / "labels" / "sem_seg" / "masks" / "train"
        suffix = ".png"
    else:
        img_dir = tmp_path / "seg" / "images" / "train"
        lbl_dir = tmp_path / "seg" / "labels" / "train"
        suffix = "_train_id.png"
    for i in range(3):
        _write_rgb(img_dir / f"b{i}.jpg", _image(rng),
                   q=[cv2.IMWRITE_JPEG_QUALITY, 90])
        mask = rng.integers(0, 19, (H, W), np.uint8)
        mask[:4] = 255
        _write_gray(lbl_dir / f"b{i}{suffix}", mask)
    _same_dataset(bdd.BDDDataset(str(tmp_path)), jbdd.BDDDataset(str(tmp_path)))
    assert bdd.CLASS_NAMES == jbdd.CLASS_NAMES


def test_bdd_without_images_or_masks_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no BDD images"):
        bdd.BDDDataset(str(tmp_path))
    _write_rgb(tmp_path / "images" / "10k" / "train" / "x.jpg",
               _image(np.random.default_rng(5)))
    with pytest.raises(FileNotFoundError, match="no mask"):
        bdd.BDDDataset(str(tmp_path))


MAPILLARY_LABELS = [
    {"name": "bird", "readable": "Bird", "color": [165, 42, 42],
     "evaluate": True},
    {"name": "ground", "readable": "Ground", "color": [0, 192, 0],
     "evaluate": False},
    {"name": "curb", "readable": "Curb", "color": [196, 196, 196]},
    {"name": "fence", "readable": "Fence", "color": [190, 153, 153],
     "evaluate": True},
    {"name": "unlabeled", "readable": "Unlabeled", "color": [0, 0, 0],
     "evaluate": False},
]


@pytest.mark.parametrize("version", ["", "v2.0"])
def test_mapillary_dataset_equals_jax(tmp_path, version):
    rng = np.random.default_rng(6)
    cfg = "config.json" if not version else f"config_{version}.json"
    (tmp_path / cfg).write_text(json.dumps({"labels": MAPILLARY_LABELS}))
    lbl_dir = tmp_path / "training" / (
        os.path.join(version, "labels") if version else "labels")
    lbl_dir.mkdir(parents=True)
    palette = np.array([lab["color"] for lab in MAPILLARY_LABELS], np.uint8)
    for i in range(3):
        _write_rgb(tmp_path / "training" / "images" / f"m{i}.jpg", _image(rng),
                   q=[cv2.IMWRITE_JPEG_QUALITY, 95])
        ids = rng.integers(0, len(MAPILLARY_LABELS), (H, W), np.uint8)
        if i < 2:   # palette masks: the index is the label id
            im = Image.fromarray(ids, mode="P")
            im.putpalette(palette.reshape(-1).tolist())
            im.save(lbl_dir / f"m{i}.png")
        else:       # a plain RGB mask: its first channel
            Image.fromarray(palette[ids]).save(lbl_dir / f"m{i}.png")
    port = mapillary.MapillaryDataset(str(tmp_path), version=version)
    ref = jmap.MapillaryDataset(str(tmp_path), version=version)
    _same_dataset(port, ref)
    np.testing.assert_array_equal(port[0][1], Image.open(port.label_paths[0]))
    assert (port.num_classes, port.class_names) == (ref.num_classes,
                                                    ref.class_names)
    assert port.class_names == ("Bird", "Curb", "Fence")
    np.testing.assert_array_equal(port.label_lookup_table(),
                                  ref.label_lookup_table())


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_data_equals_jax(seed):
    for port, ref in ((synthetic.synthetic_batch(2, 40, 72, 19, seed=seed),
                       jsyn.synthetic_batch(2, 40, 72, 19, seed=seed)),
                      (synthetic.synthetic_uint8_batch(2, 40, 72, 5,
                                                       seed=seed),
                       jsyn.synthetic_uint8_batch(2, 40, 72, 5, seed=seed))):
        for a, b in zip(port, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    ds, ref = (synthetic.ShapesDataset(5, 48, 80, seed=seed),
               jsyn.ShapesDataset(5, 48, 80, seed=seed))
    assert len(ds) == len(ref) == 5
    assert (ds.NUM_CLASSES, ds.CLASS_NAMES) == (ref.NUM_CLASSES,
                                                ref.CLASS_NAMES)
    for i in range(5):
        for a, b in zip(ds[i], ref[i]):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
