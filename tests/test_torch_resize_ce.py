"""PyTorch port, the fused resize + CE loss (K1) on the CPU, where its
wrapper runs the plain version: against the JAX package's Pallas kernel in
interpret mode (`pallas_resize_ce.resize_cross_entropy(..., interpret=True)`),
value and d(logits), at the cases of `test_pallas_resize_ce.py`, with and
without class weights, under both `align_corners`.

Tolerances: both sides round at the same points (bf16 H pass, f32 W pass,
bf16 logz residual, bf16 cotangent and transposed W pass); they differ in
float32 summation order and in `exp`/`log` to the last bit. That moves the
loss by about 1e-6 relative (bar 1e-4), and can flip a bf16 rounding of the
cotangent, which moves d(logits) by a bf16 step of its scale (bar: two
bf16 steps, 2^-7 of the largest |d(logits)|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu import losses as jlosses
from torch_semantic_segmentation_tpu.losses import (
    resize_cross_entropy_loss as j_resize_ce_loss)
from torch_semantic_segmentation_tpu.ops import pallas_resize_ce as prce
from torch_semantic_segmentation_tpu_torch import losses as tlosses
from torch_semantic_segmentation_tpu_torch.losses import (
    cross_entropy_loss, resize_cross_entropy_loss)
from torch_semantic_segmentation_tpu_torch.ops import resize_ce

torch.set_num_threads(2)

CASES = [((2, 8, 16, 19), (64, 128)),     # x8, one JAX row tile
         ((1, 16, 16, 19), (128, 128)),   # x8, two JAX row tiles
         ((2, 8, 32, 4), (32, 128))]      # x4, small C
D_TOL = 2.0 ** -7   # of max|d(logits)|: two bf16 steps at the top


def _data(lshape, yshape, *, weights, seed=0, label_dtype=np.int32):
    rng = np.random.default_rng(seed)
    n, h, w, c = lshape
    logits = (rng.normal(size=lshape) * 2.0).astype(np.float32)
    labels = rng.integers(0, c, (n, *yshape))
    labels[:, :3, :5] = 255                      # ignored pixels
    cw = rng.uniform(0.5, 2.0, (c,)).astype(np.float32) if weights else None
    return logits, labels.astype(label_dtype), cw


def _jax(logits, labels, cw, align_corners, fn):
    """JAX value and d(logits) of `fn(logits_bf16)`."""
    lj = jnp.asarray(logits, jnp.bfloat16)
    val, grad = jax.value_and_grad(fn)(lj)
    return float(val), np.asarray(grad, np.float32)


def _port(logits, labels, cw, fn):
    lt = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_(True)
    val = fn(lt, torch.from_numpy(labels),
             None if cw is None else torch.from_numpy(cw))
    val.backward()
    assert lt.grad.dtype == torch.bfloat16
    return float(val.detach()), lt.grad.float().numpy()


def _assert_close(got, want):
    (gv, gd), (wv, wd) = got, want
    np.testing.assert_allclose(gv, wv, rtol=1e-4)
    assert gd.shape == wd.shape
    np.testing.assert_allclose(gd, wd, rtol=0,
                               atol=D_TOL * np.abs(wd).max())


@pytest.mark.parametrize("lshape,yshape", CASES)
@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_ce_matches_jax_kernel(lshape, yshape, weights, align_corners):
    logits, labels, cw = _data(lshape, yshape, weights=weights)
    want = _jax(logits, labels, cw, align_corners,
                lambda lg: prce.resize_cross_entropy(
                    lg, jnp.asarray(labels), None if cw is None
                    else jnp.asarray(cw), align_corners=align_corners,
                    interpret=True))
    got = _port(logits, labels, cw,
                lambda lg, lab, w: resize_ce.resize_cross_entropy(
                    lg, lab, w, align_corners=align_corners))
    _assert_close(got, want)


def test_loss_routes_bf16_to_the_fused_op_and_takes_any_label_type():
    """`resize_cross_entropy_loss` takes the fused op for bf16 logits; the
    result is the same for uint8, int32 and int64 labels."""
    lshape, yshape = CASES[0]
    results = []
    for dt in (np.uint8, np.int32, np.int64):
        logits, labels, cw = _data(lshape, yshape, weights=True,
                                   label_dtype=dt)
        before = resize_ce.resize_ce_forward.launches
        results.append(_port(logits, labels, cw,
                             lambda lg, lab, w: resize_cross_entropy_loss(
                                 lg, lab, class_weights=w)))
        # the CPU runs the plain version: the kernel's counter stays
        assert resize_ce.resize_ce_forward.launches == before
    for r in results[1:]:
        assert r[0] == results[0][0]
        np.testing.assert_array_equal(r[1], results[0][1])
    direct = _port(*_data(lshape, yshape, weights=True),
                   lambda lg, lab, w: resize_ce.resize_cross_entropy(lg, lab, w))
    assert direct[0] == results[0][0]


def test_all_ignored_is_zero():
    logits, labels, _ = _data((2, 8, 16, 19), (64, 128), weights=False)
    labels[:] = 255
    val, grad = _port(logits, labels, None,
                      lambda lg, lab, w: resize_ce.resize_cross_entropy(lg, lab))
    assert val == 0.0
    assert not grad.any()


@pytest.mark.parametrize("align_corners", [False, True])
def test_ragged_width_against_jax_xla_branch(align_corners):
    """OW=96 (not a multiple of 128): the JAX package takes its XLA branch
    (bf16 resize matmuls, W pass first), which rounds at other points, so
    the bar is that of test_pallas_resize_ce.py (rtol 2e-2 on the loss;
    rtol 8e-2 and 2e-2 of scale on d(logits))."""
    logits, labels, cw = _data((2, 8, 12, 19), (64, 96), weights=True)
    want = _jax(logits, labels, cw, align_corners,
                lambda lg: j_resize_ce_loss(
                    lg, jnp.asarray(labels), class_weights=jnp.asarray(cw),
                    align_corners=align_corners))
    gv, gd = _port(logits, labels, cw,
                   lambda lg, lab, w: resize_cross_entropy_loss(
                       lg, lab, class_weights=w, align_corners=align_corners))
    np.testing.assert_allclose(gv, want[0], rtol=2e-2)
    np.testing.assert_allclose(gd, want[1], rtol=8e-2,
                               atol=2e-2 * np.abs(want[1]).max())


@pytest.mark.parametrize("weights", [False, True])
def test_float32_branch_matches_jax(weights):
    """float32 logits take the plain branch on both sides: 1e-5."""
    logits, labels, cw = _data((2, 8, 16, 19), (64, 128), weights=weights)
    lj = jnp.asarray(logits)
    fn = lambda lg: j_resize_ce_loss(lg, jnp.asarray(labels),  # noqa: E731
                                     class_weights=None if cw is None
                                     else jnp.asarray(cw))
    wv, wd = jax.value_and_grad(fn)(lj)
    lt = torch.from_numpy(logits).requires_grad_(True)
    val = resize_cross_entropy_loss(
        lt, torch.from_numpy(labels),
        class_weights=None if cw is None else torch.from_numpy(cw))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(wv), rtol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(wd), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(wd)).max())


def test_cross_entropy_matches_torch():
    """The port's full-resolution CE is torch's F.cross_entropy with class
    weights and ignore_index."""
    logits, labels, cw = _data((2, 6, 8, 5), (6, 8), weights=True)
    lt = torch.from_numpy(logits)
    lab = torch.from_numpy(labels).long()
    got = cross_entropy_loss(lt, lab, class_weights=torch.from_numpy(cw))
    want = torch.nn.functional.cross_entropy(
        lt.permute(0, 3, 1, 2), lab, weight=torch.from_numpy(cw),
        ignore_index=255)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("label", [5, 7])
@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("route", ["ce", "ohem", "resize_xla", "k1_plain"])
def test_labels_from_c_to_ignore_index(route, weights, label):
    """A label in [C, ignore_index) with C = 5 (4 for K1's case), float32.
    The plain paths follow the JAX package's one-hot rule: true logit 0,
    weight 1, or 0 under class weights (`cross_entropy_loss` 1.97992 on
    1x4x4 logits from seed 0 with one such label), at 1e-6 relative, and
    the float32 resize branch its XLA route at `test_float32_branch_
    matches_jax`'s 1e-5. K1's plain version keeps the Pallas rule, weight
    0: its value equals that with those pixels ignored, and the
    interpret-mode kernel's at `_assert_close`'s bars."""
    rng = np.random.default_rng(0)
    cw = rng.uniform(0.5, 2.0, (5,)).astype(np.float32) if weights else None
    jcw = None if cw is None else jnp.asarray(cw)
    tcw = None if cw is None else torch.from_numpy(cw)
    if route in ("ce", "ohem"):
        gen = np.random.default_rng(0)
        logits = gen.normal(size=(1, 4, 4, 5)).astype(np.float32)
        labels = gen.integers(0, 5, (1, 4, 4)).astype(np.int32)
        labels[0, 0, 0] = label
        if route == "ce" and not weights and label == 5:
            np.testing.assert_allclose(float(tlosses.cross_entropy_loss(
                torch.from_numpy(logits), torch.from_numpy(labels))),
                1.97992, rtol=1e-5)
        labels[0, 3, 3] = 255
        lj, yj = jnp.asarray(logits), jnp.asarray(labels)
        lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
        if route == "ce":
            want = float(jlosses.cross_entropy_loss(lj, yj, class_weights=jcw))
            got = float(tlosses.cross_entropy_loss(lt, yt, class_weights=tcw))
        else:
            kw = dict(thresh=0.7, min_kept=4)
            want = float(jlosses.ohem_cross_entropy(lj, yj, class_weights=jcw,
                                                    **kw))
            got = float(tlosses.ohem_cross_entropy(lt, yt, class_weights=tcw,
                                                   **kw))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    elif route == "resize_xla":
        logits = (rng.normal(size=(2, 2, 2, 5)) * 2.0).astype(np.float32)
        labels = rng.integers(0, 5, (2, 16, 16)).astype(np.int32)
        labels[0, :3, :3] = label
        labels[1, 5, :4] = 255
        fn = lambda lg: j_resize_ce_loss(  # noqa: E731
            lg, jnp.asarray(labels), class_weights=jcw)
        wv, wd = jax.value_and_grad(fn)(jnp.asarray(logits))
        lt = torch.from_numpy(logits).requires_grad_(True)
        val = resize_cross_entropy_loss(lt, torch.from_numpy(labels),
                                        class_weights=tcw)
        val.backward()
        np.testing.assert_allclose(float(val.detach()), float(wv), rtol=1e-5)
        np.testing.assert_allclose(lt.grad.numpy(), np.asarray(wd), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(wd)).max())
    else:
        lshape, yshape = CASES[2]
        logits, labels, cw4 = _data(lshape, yshape, weights=weights)
        labels[:, 10:12, 7:40] = label
        fn = lambda lg, lab, w: resize_cross_entropy_loss(  # noqa: E731
            lg, lab, class_weights=w)
        got = _port(logits, labels, cw4, fn)
        ignored = labels.copy()
        ignored[:, 10:12, 7:40] = 255
        as_ignored = _port(logits, ignored, cw4, fn)
        assert got[0] == as_ignored[0]
        np.testing.assert_array_equal(got[1], as_ignored[1])
        want = _jax(logits, labels, cw4, False,
                    lambda lg: prce.resize_cross_entropy(
                        lg, jnp.asarray(labels), None if cw4 is None
                        else jnp.asarray(cw4), interpret=True))
        _assert_close(got, want)


def test_clipped_exponentials_stay_above_flt_min():
    """The card's forward takes its exponentials as ex2.approx.ftz of
    y·log2(e) and logz by lg2.approx.ftz (csrc/resize_ce.cu). After the ±80
    clip the least of them is exp(−80) ≈ 1.8e−35, a normal float32 above
    FLT_MIN (1.18e−38), and so is a class sum of one such term: flushing
    denormals to zero changes no value."""
    tiny = np.finfo(np.float32).tiny
    clip = np.float32(resize_ce._CLIP)
    least = torch.exp(torch.tensor(-clip, dtype=torch.float32))
    assert float(least) > tiny
    assert np.exp2(-clip * np.float32(np.log2(np.e)), dtype=np.float32) > tiny
    assert bool(torch.isfinite(torch.log(least)))
