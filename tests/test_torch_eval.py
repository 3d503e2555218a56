"""PyTorch port, evaluation on the CPU against the JAX package:

- `update_confusion_matrix` equals the JAX one exactly below 2^24, labels
  outside [0, C) and `ignore_index` left out on both sides;
- past 2^24 the port counts exactly, while the JAX package's float32
  matrix stops at 2^24 (asserted too, to pin the reference's fault);
- `iou_from_confusion_matrix` and the pixel accuracy equal JAX's;
- `make_eval_step` and `make_multiscale_eval_step` (scales 0.5, 1.0, 1.5
  with flip) against JAX's, FastSCNN in float32 with the JAX weights and
  BN statistics set from the batch (`calibrate_bn`, so that the ids vary),
  dropout rate 0, at 2x64x128 on blocks of colour plus noise: the matrices
  hold the same number of pixels, exactly, and the predicted ids differ on
  at most 1e-3 of the pixels (the serving path's bar). The port's ids are read from the
  matrix update and fed to the JAX step as labels: the JAX matrix's trace
  then counts the pixels where the two agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu import eval as jeval
from torch_semantic_segmentation_tpu import metrics as jmetrics
from torch_semantic_segmentation_tpu import train as jtrain
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.models.fastscnn import (
    fastscnn as j_fastscnn)
from torch_semantic_segmentation_tpu_torch import eval as teval
from torch_semantic_segmentation_tpu_torch import metrics as tmetrics
from torch_semantic_segmentation_tpu_torch import train as ttrain
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax
from torch_semantic_segmentation_tpu_torch.models import fastscnn

from tests.torch_port_util import calibrate_bn

torch.set_num_threads(2)

C = 19


def _preds_labels(shape, seed=0, classes=C):
    rng = np.random.default_rng(seed)
    preds = rng.integers(0, classes, shape).astype(np.int32)
    labels = rng.integers(0, classes, shape).astype(np.int32)
    labels[:, :3] = 255                      # ignored rows
    labels[:, -1, :5] = classes + 4          # outside [0, C), not ignored
    return preds, labels


def test_update_matches_jax_exactly():
    preds, labels = _preds_labels((2, 64, 128))
    cm_t = tmetrics.new_confusion_matrix(C, "cpu")
    cm_j = jmetrics.new_confusion_matrix(C)
    for _ in range(2):
        cm_t = tmetrics.update_confusion_matrix(
            cm_t, torch.from_numpy(preds), torch.from_numpy(labels))
        cm_j = jmetrics.update_confusion_matrix(cm_j, jnp.asarray(preds),
                                                jnp.asarray(labels))
    assert cm_t.dtype == torch.int64
    np.testing.assert_array_equal(cm_t.numpy(), np.asarray(cm_j))
    assert int(cm_t.sum()) == 2 * int(((labels != 255) & (labels < C)).sum())


# (start of cell [0, 0], pixels added to it in one update)
PAST_2_24 = {"a cell at 2^24, 4096 more": (2 ** 24, 4096),
             "one batch of 2^24 + 1000": (0, 2 ** 24 + 1000)}


@pytest.mark.parametrize("case", list(PAST_2_24))
def test_counts_exactly_past_2_24(case):
    start, pixels = PAST_2_24[case]
    zeros = np.zeros(pixels, np.int32)
    cm_t = tmetrics.new_confusion_matrix(4, "cpu")
    cm_t[0, 0] = start
    cm_t = tmetrics.update_confusion_matrix(cm_t, torch.from_numpy(zeros),
                                            torch.from_numpy(zeros))
    assert int(cm_t[0, 0]) == start + pixels
    # the JAX package's float32 matrix stops counting at 2^24
    cm_j = jmetrics.new_confusion_matrix(4).at[0, 0].set(float(start))
    cm_j = jmetrics.update_confusion_matrix(cm_j, jnp.asarray(zeros),
                                            jnp.asarray(zeros))
    assert float(cm_j[0, 0]) == 2.0 ** 24


def test_iou_and_accuracy_match_jax():
    preds, labels = _preds_labels((2, 16, 32), seed=1, classes=6)
    labels[labels == 5] = 255                # a class with no support
    cm = tmetrics.update_confusion_matrix(
        tmetrics.new_confusion_matrix(6, "cpu"), torch.from_numpy(preds),
        torch.from_numpy(labels))
    iou, miou = tmetrics.iou_from_confusion_matrix(cm)
    want_iou, want_miou = jmetrics.iou_from_confusion_matrix(cm.numpy())
    np.testing.assert_array_equal(iou, want_iou)
    assert miou == want_miou and 0.0 < miou < 1.0
    assert (tmetrics.pixel_accuracy_from_confusion_matrix(cm)
            == jmetrics.pixel_accuracy_from_confusion_matrix(cm.numpy()))


def _batch():
    """8x8 blocks of random colour plus noise, random labels with a band
    of ignored rows."""
    rng = np.random.default_rng(2)
    base = rng.normal(size=(2, 8, 16, 3))
    x = np.repeat(np.repeat(base, 8, 1), 8, 2)
    x = (x + 0.3 * rng.normal(size=x.shape)).astype(np.float32)
    y = rng.integers(0, C, (2, 64, 128)).astype(np.int32)
    y[:, :8] = 255
    return x, y


def _models():
    j = j_fastscnn(C, upsample_logits=False, rngs=nnx.Rngs(0))
    j.classifier.dropout.rate = 0.0
    calibrate_bn(j, _batch()[0], seed=3)
    t = fastscnn(C, upsample_logits=False, device="cpu")
    t.load_state_dict(state_dict_from_jax(export_torch_state_dict(j)),
                      strict=True)
    _, gd_eval, params, rest = jtrain.split_train_eval(j)
    return gd_eval, params, rest, t


def _port_ids(monkeypatch, step, cm, x, y):
    """(the port step's matrix, the ids it counted)."""
    seen = []
    real = tmetrics.update_confusion_matrix

    def record(cm, preds, labels, **kw):
        seen.append(preds.clone())
        return real(cm, preds, labels, **kw)

    monkeypatch.setattr(tmetrics, "update_confusion_matrix", record)
    cm = step(cm, x, y)
    monkeypatch.setattr(tmetrics, "update_confusion_matrix", real)
    (ids,) = seen
    return cm, ids


@pytest.mark.parametrize("multiscale", [False, True])
def test_eval_step_matches_jax(monkeypatch, multiscale):
    gd_eval, params, rest, t = _models()
    x, y = _batch()
    if multiscale:
        kw = dict(num_classes=C, scales=(0.5, 1.0, 1.5), flip=True)
        jstep = jeval.make_multiscale_eval_step(gd_eval, **kw)
        tstep = teval.make_multiscale_eval_step(t, device="cpu", **kw)
    else:
        jstep = jtrain.make_eval_step(gd_eval, num_classes=C)
        tstep = ttrain.make_eval_step(t, num_classes=C, device="cpu")
    cm_t, ids = _port_ids(monkeypatch, tstep,
                          tmetrics.new_confusion_matrix(C, "cpu"), x, y)
    cm_j = jstep(params, rest, jmetrics.new_confusion_matrix(C),
                 jnp.asarray(x), jnp.asarray(y))
    assert ids.shape == y.shape and ids.dtype in (torch.int32, torch.int64)
    assert int((torch.bincount(ids.flatten()) > 0).sum()) >= 5
    assert int(cm_t.sum()) == int(np.asarray(cm_j).sum()) \
        == int((y != 255).sum())
    # the JAX step's ids against the port's, counted by the JAX step
    agree = jstep(params, rest, jmetrics.new_confusion_matrix(C),
                  jnp.asarray(x), jnp.asarray(ids.numpy().astype(np.int32)))
    agree = np.asarray(agree)
    assert agree.sum() == ids.numel()
    assert 1.0 - np.trace(agree) / ids.numel() <= 1e-3
    mismatch = np.abs(cm_t.numpy() - np.asarray(cm_j)).sum() / 2
    assert mismatch <= 1e-3 * ids.numel()


def test_evaluate_and_entry_points(monkeypatch):
    gd_eval, params, rest, t = _models()
    x, y = _batch()
    step = ttrain.make_eval_step(t, num_classes=C, device="cpu")
    iou, miou, cm = teval.evaluate(step, [(x, y), (x, y)], num_classes=C,
                                   device="cpu")
    want = jeval.evaluate(jtrain.make_eval_step(gd_eval, num_classes=C),
                          params, rest, [(jnp.asarray(x), jnp.asarray(y))] * 2,
                          num_classes=C)
    assert int(cm.sum()) == 2 * int((y != 255).sum())
    assert abs(miou - want[1]) <= 1e-3 and iou.shape == (C,)
    with pytest.raises(ValueError, match="confusion matrix"):
        step(tmetrics.new_confusion_matrix(C - 1, "cpu"), x, y)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ttrain.make_eval_step(t, num_classes=C),
                 lambda: teval.make_multiscale_eval_step(t, num_classes=C),
                 lambda: tmetrics.new_confusion_matrix(C)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
