"""PyTorch port, the CLIs' shared plumbing (`cli/common.py`) and the train
CLI's parser against the JAX package's:

- `build_dataset`'s bundle for each of the six datasets (files written to
  `tmp_path` for the four file datasets): every sample's arrays, the LUT,
  the class weights, the class names, the palette, mean and std equal;
  a file dataset without `--dataset-dir` and an unknown name raise the
  same `ValueError`;
- `build_loss` against JAX's `build_loss` on the same logits and labels,
  value and d(logits) of every head, for each of CE and OHEM, fused resize
  or not, class weights or none, one head or a main and an aux head:
  float32 logits (the plain paths of both packages) at rtol 1e-5, atol
  1e-5 of the largest |d(logits)|; the fused routes again on bf16 logits,
  the JAX side through its Pallas kernels in interpret mode, at the bars
  of `test_torch_resize_ce.py` and `test_torch_ohem.py` (loss rtol 1e-4,
  d(logits) two bf16 steps, 2^-7 of the largest); an unknown loss raises
  `ValueError` in both;
- `parse_args(["--config", c, ...])` equals the JAX parser's namespace on
  every key both have, for each of `configs/*.json`, with and without
  explicit flags overriding the file, and with no config at all."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu.cli import common as jcommon
from torch_semantic_segmentation_tpu.cli import train as jtrain_cli
from torch_semantic_segmentation_tpu.ops import pallas_resize_ce as prce
from torch_semantic_segmentation_tpu_torch.cli import common
from torch_semantic_segmentation_tpu_torch.cli import train as train_cli

from tests.torch_port_util import (
    write_bdd_tree, write_camvid_tree, write_cityscapes_tree,
    write_mapillary_tree)

torch.set_num_threads(2)

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs")
                 .glob("*.json"))
D_TOL = 2.0 ** -7   # of max|d(logits)|: two bf16 steps at the top


def _same_bundle(port, ref):
    for field in ("num_classes", "ignore_index", "class_names", "mean",
                  "std"):
        assert getattr(port, field) == getattr(ref, field), field
    for field in ("label_lut", "class_weights", "palette"):
        a, b = getattr(port, field), getattr(ref, field)
        assert (a is None) == (b is None), field
        if a is not None:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b)
    assert len(port.dataset) == len(ref.dataset) > 0
    for i in range(len(ref.dataset)):
        for a, b in zip(port.dataset[i], ref.dataset[i], strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["cityscapes", "camvid", "bdd",
                                  "mapillary"])
def test_file_dataset_bundle_equals_jax(tmp_path, name):
    rng = np.random.default_rng(11)
    {"cityscapes": write_cityscapes_tree, "camvid": write_camvid_tree,
     "bdd": write_bdd_tree, "mapillary": write_mapillary_tree}[name](
         tmp_path, rng)
    _same_bundle(common.build_dataset(name, str(tmp_path), "train"),
                 jcommon.build_dataset(name, str(tmp_path), "train"))


@pytest.mark.parametrize("name", ["synthetic", "shapes"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_in_memory_bundle_equals_jax(name, split):
    size = (4, 24, 40)
    _same_bundle(common.build_dataset(name, None, split, synthetic_size=size),
                 jcommon.build_dataset(name, None, split, synthetic_size=size))


@pytest.mark.parametrize("name", ["cityscapes", "camvid", "bdd",
                                  "mapillary", "imagenet"])
def test_build_dataset_refusals_equal_jax(name):
    with pytest.raises(ValueError) as want:
        jcommon.build_dataset(name, None, "train")
    with pytest.raises(ValueError) as got:
        common.build_dataset(name, None, "train")
    assert str(got.value) == str(want.value)


def _loss_case(fused: bool, weights: bool, aux: bool, seed: int = 0):
    """Logits of the main head (and of an aux head) and labels: low-res
    (2,8,16,C) against labels (2,64,128) on the fused route, else at the
    labels' size; some ignored pixels."""
    rng = np.random.default_rng(seed)
    c = 19
    shape = (2, 8, 16, c) if fused else (2, 16, 24, c)
    lab_shape = (2, 64, 128) if fused else shape[:3]
    heads = [(rng.normal(size=shape) * 2.0).astype(np.float32)
             for _ in range(2 if aux else 1)]
    labels = rng.integers(0, c, lab_shape).astype(np.int32)
    labels[:, :3, :5] = 255
    cw = rng.uniform(0.5, 2.0, (c,)).astype(np.float32) if weights else None
    return heads, labels, cw


def _loss_kwargs(loss, fused, cw):
    return dict(ignore_index=255, aux_weight=0.4, class_weights=cw,
                ohem_thresh=0.7, ohem_min_kept=500, fused_resize=fused)


def _both(loss, fused, heads, labels, cw, dtype):
    """(value, [d(head)]) of the JAX and the port's `build_loss`."""
    kw = _loss_kwargs(loss, fused, cw)
    jfn = jcommon.build_loss(loss, **kw)
    tfn = common.build_loss(loss, device="cpu", **kw)
    jl = jnp.asarray(labels)

    def jloss(hs):
        return jfn(tuple(hs) if len(hs) > 1 else hs[0], jl)

    wv, wd = jax.value_and_grad(jloss)([jnp.asarray(h, dtype)
                                        for h in heads])
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    ts = [torch.from_numpy(h).to(tdtype).requires_grad_(True) for h in heads]
    val = tfn(tuple(ts) if len(ts) > 1 else ts[0], torch.from_numpy(labels))
    val.backward()
    return ((float(val.detach()), [t.grad.float().numpy() for t in ts]),
            (float(wv), [np.asarray(d, np.float32) for d in wd]))


@pytest.mark.parametrize("loss", ["ce", "ohem"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("aux", [False, True])
def test_build_loss_float32_equals_jax(loss, fused, weights, aux):
    heads, labels, cw = _loss_case(fused, weights, aux)
    (gv, gd), (wv, wd) = _both(loss, fused, heads, labels, cw, jnp.float32)
    np.testing.assert_allclose(gv, wv, rtol=1e-5)
    for g, w in zip(gd, wd, strict=True):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("loss", ["ce", "ohem"])
@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("aux", [False, True])
def test_build_loss_fused_bf16_equals_jax_kernels(monkeypatch, loss, weights,
                                                  aux):
    """The bf16 fused routes: K1's and K3's plain versions in the port, the
    JAX package's Pallas kernels in interpret mode."""
    monkeypatch.setenv("TPU_SEG_PALLAS_CE", "1")
    monkeypatch.setattr(prce, "resize_cross_entropy", functools.partial(
        prce.resize_cross_entropy, interpret=True))
    monkeypatch.setattr(prce, "per_pixel_resize_ce", functools.partial(
        prce.per_pixel_resize_ce, interpret=True))
    heads, labels, cw = _loss_case(True, weights, aux, seed=1)
    (gv, gd), (wv, wd) = _both(loss, True, heads, labels, cw, jnp.bfloat16)
    np.testing.assert_allclose(gv, wv, rtol=1e-4)
    for g, w in zip(gd, wd, strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=D_TOL * np.abs(w).max())


def test_unknown_loss_raises_as_in_jax():
    kw = _loss_kwargs("focal", False, None)
    with pytest.raises(ValueError) as want:
        jcommon.build_loss("focal", **kw)
    with pytest.raises(ValueError) as got:
        common.build_loss("focal", device="cpu", **kw)
    assert str(got.value) == str(want.value)


def _shared(port, ref) -> dict:
    a, b = vars(port), vars(ref)
    shared = set(a) & set(b)
    assert set(a) - shared == {"device", "dist_backend", "dist_init_method"}
    assert set(b) - shared == set()
    return shared


@pytest.mark.parametrize("config", CONFIGS, ids=lambda p: p.stem)
@pytest.mark.parametrize("extra", [[], ["--lr", "0.123", "--batch-size=2",
                                        "--no-bf16", "--remat"]])
def test_parse_args_with_config_equals_jax(config, extra):
    argv = ["--config", str(config), *extra]
    port, ref = train_cli.parse_args(argv), jtrain_cli.parse_args(argv)
    for key in _shared(port, ref):
        assert getattr(port, key) == getattr(ref, key), key
    if extra:
        assert (port.lr, port.batch_size, port.remat) == (0.123, 2, True)


def test_parse_args_defaults_equal_jax():
    port, ref = train_cli.parse_args([]), jtrain_cli.parse_args([])
    for key in _shared(port, ref):
        assert getattr(port, key) == getattr(ref, key), key
    assert port.device is None
    assert port.multihost is False
    assert train_cli.parse_args(["--multihost"]).multihost is True
