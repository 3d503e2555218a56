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

import os

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

from tests.torch_port_util import (
    smooth_image as _image, write_bdd_tree, write_camvid_tree,
    write_cityscapes_tree, write_mapillary_tree, write_rgb as _write_rgb)


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
    write_cityscapes_tree(tmp_path, np.random.default_rng(0))
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
    write_camvid_tree(tmp_path, np.random.default_rng(2), layout)
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
    write_bdd_tree(tmp_path, np.random.default_rng(4), layout)
    _same_dataset(bdd.BDDDataset(str(tmp_path)), jbdd.BDDDataset(str(tmp_path)))
    assert bdd.CLASS_NAMES == jbdd.CLASS_NAMES


def test_bdd_without_images_or_masks_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no BDD images"):
        bdd.BDDDataset(str(tmp_path))
    _write_rgb(tmp_path / "images" / "10k" / "train" / "x.jpg",
               _image(np.random.default_rng(5)))
    with pytest.raises(FileNotFoundError, match="no mask"):
        bdd.BDDDataset(str(tmp_path))


@pytest.mark.parametrize("version", ["", "v2.0"])
def test_mapillary_dataset_equals_jax(tmp_path, version):
    write_mapillary_tree(tmp_path, np.random.default_rng(6), version)
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
