"""PyTorch port, OHEM cross-entropy and the per-pixel resize + CE map (K3)
on the CPU, where K3's wrappers run the plain version, against the JAX
package:

- K3's plain map and logz, and its backward for a cotangent map, against
  `pallas_resize_ce.per_pixel_resize_ce(..., interpret=True)`: the map at
  rtol = atol = 1e-5 (the same rounding points; float32 summation order
  and `exp`/`log` differ in the last bit), d(logits) within two bf16 steps
  of its largest element (a last-bit difference may flip the bf16 rounding
  of the cotangent, as in tests/test_torch_resize_ce.py);
- `resize_ohem_cross_entropy` with bf16 logits, the port through K3 and the
  JAX package through its Pallas map kernel in interpret mode, value at
  1e-4 and d(logits) as above;
- `ohem_cross_entropy` and `resize_ohem_cross_entropy` with float32 logits
  against the JAX package's XLA path, value and gradient at 1e-5, with
  the exact top-k and with the bisection, with and without class weights;
- both threshold functions, the bisection on a map of more than 2^20
  pixels, equal to the JAX package's bit for bit;
- a fault in the reference, which the port does not copy: a label in
  [C, ignore_index) kept by OHEM with class weights. The port gives it
  weight 0 and equals the JAX package's XLA route; the JAX package's
  Pallas route weighs it with cw[C−1] (`losses/__init__.py:347` clamps
  the index) and differs by more than 0.1 relative."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu import losses as jlosses
from torch_semantic_segmentation_tpu.ops import pallas_resize_ce as prce
from torch_semantic_segmentation_tpu_torch import losses as tlosses
from torch_semantic_segmentation_tpu_torch.ops import resize_ce

torch.set_num_threads(2)

D_TOL = 2.0 ** -7   # of max|d(logits)|: two bf16 steps at the top
LSHAPE, YSHAPE = (2, 4, 8, 19), (64, 128)   # a shape prce.supports() takes


def _data(lshape, yshape, *, seed=0, weights=False, scale=2.0):
    rng = np.random.default_rng(seed)
    n, h, w, c = lshape
    logits = (rng.normal(size=lshape) * scale).astype(np.float32)
    labels = rng.integers(0, c, (n, *yshape)).astype(np.int32)
    labels[:, :3, :5] = 255
    cw = rng.uniform(0.5, 2.0, (c,)).astype(np.float32) if weights else None
    return logits, labels, cw


# the even shape both ways, and x16 (K3's ratio on DeepLab's path) with
# W over one 16-column tile and neither side a multiple of 128
@pytest.mark.parametrize("align_corners,lshape,yshape", [
    (False, LSHAPE, YSHAPE), (True, LSHAPE, YSHAPE),
    (False, (1, 5, 21, 19), (80, 336))], ids=["False", "True", "x16-ragged"])
def test_map_plain_version_matches_jax_kernel(align_corners, lshape, yshape):
    logits, labels, _ = _data(lshape, yshape)
    ct = np.random.default_rng(1).normal(size=(lshape[0], *yshape)).astype(
        np.float32)
    lj = jnp.asarray(logits, jnp.bfloat16)
    fn = functools.partial(prce.per_pixel_resize_ce,
                           labels=jnp.asarray(labels),
                           align_corners=align_corners, interpret=True)
    want_map, vjp = jax.vjp(fn, lj)
    want_dx = np.asarray(vjp(jnp.asarray(ct))[0], np.float32)
    want_map = np.asarray(want_map)

    lt = torch.from_numpy(logits).to(torch.bfloat16)
    lab = torch.from_numpy(labels)
    before = resize_ce.resize_ce_map_forward.launches
    got_map, logz = resize_ce.resize_ce_map_forward(lt, lab, align_corners)
    assert resize_ce.resize_ce_map_forward.launches == before
    assert got_map.dtype == torch.float32 and logz.dtype == torch.bfloat16
    np.testing.assert_allclose(got_map.numpy(), want_map, rtol=1e-5,
                               atol=1e-5)
    assert not got_map.numpy()[:, :3, :5].any()       # ignored pixels are 0
    dx = resize_ce.resize_ce_map_backward(lt, lab, logz, torch.from_numpy(ct),
                                          align_corners)
    assert dx.dtype == torch.bfloat16 and dx.shape == lt.shape
    np.testing.assert_allclose(dx.float().numpy(), want_dx, rtol=0,
                               atol=D_TOL * np.abs(want_dx).max())

    # the autograd op: the same map and the same d(logits)
    lg = lt.clone().requires_grad_(True)
    m = resize_ce.per_pixel_resize_ce(lg, lab, align_corners=align_corners)
    m.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(m.detach().numpy(), got_map.numpy())
    np.testing.assert_array_equal(lg.grad.float().numpy(), dx.float().numpy())


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("min_kept", [500, 20_000])
def test_resize_ohem_bf16_matches_jax_kernel_route(monkeypatch, weights,
                                                   min_kept):
    """min_kept 500: the −log(0.7) threshold decides; 20,000 (over the
    16,384 pixels): the k-th largest does."""
    monkeypatch.setenv("TPU_SEG_PALLAS_CE", "1")
    monkeypatch.setattr(prce, "per_pixel_resize_ce", functools.partial(
        prce.per_pixel_resize_ce, interpret=True))
    logits, labels, cw = _data(LSHAPE, YSHAPE, seed=2, weights=weights)
    kw = dict(thresh=0.7, min_kept=min_kept)
    wv, wd = jax.value_and_grad(lambda lg: jlosses.resize_ohem_cross_entropy(
        lg, jnp.asarray(labels), class_weights=None if cw is None
        else jnp.asarray(cw), **kw))(jnp.asarray(logits, jnp.bfloat16))
    wd = np.asarray(wd, np.float32)
    lt = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_(True)
    val = tlosses.resize_ohem_cross_entropy(
        lt, torch.from_numpy(labels),
        class_weights=None if cw is None else torch.from_numpy(cw), **kw)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(wv), rtol=1e-4)
    np.testing.assert_allclose(lt.grad.float().numpy(), wd, rtol=0,
                               atol=D_TOL * np.abs(wd).max())


def _value_and_grad_pair(jfn, tfn, logits):
    wv, wd = jax.value_and_grad(jfn)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    val = tfn(lt)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(wv), rtol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(wd), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(wd)).max())


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("min_kept", [100, 3000])
def test_ohem_matches_jax(exact, weights, min_kept):
    logits, labels, cw = _data((2, 24, 32, 7), (24, 32), seed=3,
                               weights=weights, scale=1.0)
    kw = dict(thresh=0.7, min_kept=min_kept, exact=exact)
    _value_and_grad_pair(
        lambda lg: jlosses.ohem_cross_entropy(
            lg, jnp.asarray(labels), class_weights=None if cw is None
            else jnp.asarray(cw), **kw),
        lambda lg: tlosses.ohem_cross_entropy(
            lg, torch.from_numpy(labels),
            class_weights=None if cw is None else torch.from_numpy(cw), **kw),
        logits)


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_ohem_float32_matches_jax(weights, align_corners):
    """float32 logits take the plain (N,OH,C,OW) path on both sides."""
    logits, labels, cw = _data((2, 6, 10, 5), (48, 80), seed=4,
                               weights=weights)
    kw = dict(thresh=0.7, min_kept=2000, align_corners=align_corners)
    before = resize_ce.resize_ce_map_forward.launches
    _value_and_grad_pair(
        lambda lg: jlosses.resize_ohem_cross_entropy(
            lg, jnp.asarray(labels), class_weights=None if cw is None
            else jnp.asarray(cw), **kw),
        lambda lg: tlosses.resize_ohem_cross_entropy(
            lg, torch.from_numpy(labels),
            class_weights=None if cw is None else torch.from_numpy(cw), **kw),
        logits)
    assert resize_ce.resize_ce_map_forward.launches == before


def test_thresholds_equal_jax_past_two_to_the_twenty():
    """The bisection on a map of 2^20 + 4096 pixels (the size at which the
    losses take it) and the exact top-k: the same float32 bits as the JAX
    package's."""
    rng = np.random.default_rng(5)
    n = (1 << 20) + 4096
    losses = rng.gamma(1.5, 0.6, n).astype(np.float32)
    valid = rng.random(n) > 0.1
    for k in (1, 100_000, int(valid.sum())):
        want = jlosses._threshold_topk_histogram(
            jnp.asarray(losses), jnp.asarray(valid), k)
        got = tlosses._threshold_topk_histogram(
            torch.from_numpy(losses), torch.from_numpy(valid), k)
        assert got.dtype == torch.float32
        assert float(got) == float(want), k
        # at least k valid losses at or above it
        assert int(((losses >= float(got)) & valid).sum()) >= k
    masked = np.where(valid, losses, -np.inf).astype(np.float32)
    want = jlosses._threshold_topk_exact(jnp.asarray(masked), 100_000)
    got = tlosses._threshold_topk_exact(torch.from_numpy(masked), 100_000)
    assert float(got) == float(want)


def test_ohem_threshold_takes_no_gradient_and_routes_bf16_to_k3():
    logits, labels, _ = _data(LSHAPE, YSHAPE, seed=6)
    lt = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_(True)
    calls = []
    real = resize_ce.resize_ce_map_forward

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    spy.launches = real.launches
    resize_ce.resize_ce_map_forward = spy
    try:
        val = tlosses.resize_ohem_cross_entropy(lt, torch.from_numpy(labels),
                                                min_kept=100)
    finally:
        resize_ce.resize_ce_map_forward = real
    assert calls == [lt.shape]
    val.backward()
    assert lt.grad is not None and torch.isfinite(lt.grad.float()).all()
    # ignore_index inside [0, C) keeps the plain path
    calls.clear()
    tlosses.resize_ohem_cross_entropy(
        lt.detach(), torch.from_numpy(np.where(labels == 255, 3, labels)),
        ignore_index=3)
    assert calls == []


def test_label_from_c_to_ignore_index_with_class_weights_under_ohem(
        monkeypatch):
    """bf16 logits (1,8,16,4) → (1,128,256): rows 0-39 ignored, rows 40-59
    hold label 5 (in [C, 255)), the rest random classes; class weights
    [1,2,3,4], thresh 0.7, min_kept 10^9, so every valid pixel is kept and
    the label-5 pixels (loss 0) count in the weighted mean's denominator:
    with weight 0 in the port and JAX's XLA route, with cw[C−1] = 4 on
    JAX's Pallas route. This draw reads port 1.903518, XLA 1.903526,
    Pallas 1.294459 (0.32 relative off)."""
    rng = np.random.default_rng(8)
    logits = (rng.normal(size=(1, 8, 16, 4)) * 2.0).astype(np.float32)
    labels = rng.integers(0, 4, (1, 128, 256)).astype(np.int32)
    labels[:, :40] = 255
    labels[:, 40:60] = 5
    cw = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    kw = dict(thresh=0.7, min_kept=10 ** 9)
    lj = jnp.asarray(logits, jnp.bfloat16)

    def jax_value():
        return float(jlosses.resize_ohem_cross_entropy(
            lj, jnp.asarray(labels), class_weights=jnp.asarray(cw), **kw))

    monkeypatch.setenv("TPU_SEG_PALLAS_CE", "0")
    xla = jax_value()
    monkeypatch.setenv("TPU_SEG_PALLAS_CE", "1")
    assert prce.supports(lj.shape, labels.shape, lj.dtype)
    monkeypatch.setattr(prce, "per_pixel_resize_ce", functools.partial(
        prce.per_pixel_resize_ce, interpret=True))
    pallas = jax_value()
    port = float(tlosses.resize_ohem_cross_entropy(
        torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(labels),
        class_weights=torch.from_numpy(cw), **kw))
    np.testing.assert_allclose(port, xla, rtol=1e-4)
    assert abs(pallas - xla) > 0.1 * abs(xla), (pallas, xla)
