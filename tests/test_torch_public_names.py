"""PyTorch port, the last public names of the JAX package on the CPU
against their JAX functions (each bar below with its reason):

- `ops.avg_pool2d`: float32 at rtol = atol = 1e-6 (both sum a window in
  float32; the order of the sum may differ), bfloat16 at one bf16 step of
  scale (the float32 mean rounds once to bf16 in both);
- `ops.resize_nearest`: bit for bit (a gather of the same source index,
  floor(i·in/out) in float64), and torch's `F.interpolate(mode="nearest")`
  bit for bit at these sizes;
- `ops.upsample2x_bilinear`: float32 at 1e-6 of scale, both
  align_corners conventions (two float32 passes of 2-hot matrices);
- `models.register`: a newly registered name is built by `get_model` and
  listed by `available_models` in both packages;
- `models.resnet.resnet(18)`: the four stage outputs in eval mode at 1e-5
  of scale, the JAX weights carried with strict=True (the bar of
  tests/test_torch_deeplab.py's blocks);
- `adaptive_avg_pool2d` copies its pool matrices to the device once for a
  shape and gives the bits of the matrices made anew."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

from torch_semantic_segmentation_tpu import models as jmodels
from torch_semantic_segmentation_tpu.models import resnet as jresnet
from torch_semantic_segmentation_tpu.ops import pool as jpool
from torch_semantic_segmentation_tpu.ops import upsample as jupsample
from torch_semantic_segmentation_tpu_torch import models, ops
from torch_semantic_segmentation_tpu_torch.models import resnet
from torch_semantic_segmentation_tpu_torch.ops import pool

from torch_port_util import carry_weights

torch.set_num_threads(2)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("window,stride,padding", [(2, None, 0), (3, 2, 1),
                                                   (3, 1, 1), (4, 2, 0)])
def test_avg_pool2d_matches_jax(window, stride, padding):
    x = _x((2, 13, 17, 6))
    want = np.asarray(jpool.avg_pool2d(jnp.asarray(x), window, stride,
                                       padding))
    got = ops.avg_pool2d(torch.from_numpy(x), window, stride, padding)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    want16 = np.asarray(jpool.avg_pool2d(jnp.asarray(x, jnp.bfloat16),
                                         window, stride, padding)
                        .astype(jnp.float32))
    got16 = ops.avg_pool2d(torch.from_numpy(x).bfloat16(), window, stride,
                           padding)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), want16, rtol=0,
                               atol=2.0 ** -8 * np.abs(want16).max())


@pytest.mark.parametrize("size,out", [((8, 12), (16, 24)), ((16, 24), (5, 7)),
                                      ((7, 9), (10, 13)), ((6, 6), (6, 6))])
def test_resize_nearest_matches_jax_and_torch(size, out):
    x = _x((2, *size, 3))
    want = np.asarray(jupsample.resize_nearest(jnp.asarray(x), out))
    got = ops.resize_nearest(torch.from_numpy(x), out)
    np.testing.assert_array_equal(got.numpy(), want)
    nchw = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=out,
                         mode="nearest")
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("align_corners", [False, True])
def test_upsample2x_bilinear_matches_jax(align_corners):
    x = _x((2, 7, 10, 5))
    want = np.asarray(jupsample.upsample2x_bilinear(
        jnp.asarray(x), align_corners=align_corners))
    got = ops.upsample2x_bilinear(torch.from_numpy(x),
                                  align_corners=align_corners)
    assert got.shape == (2, 14, 20, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_register_makes_a_name_get_model_builds():
    """The same constructor registered in both packages: `get_model` calls
    it with the classes and the keywords, and both registries list it."""
    calls = []

    def toy(num_classes, **kwargs):
        calls.append((num_classes, kwargs))
        return ("toy", num_classes)

    jmodels.available_models()       # the JAX registry fills at first use
    try:
        assert jmodels.register("toy_net")(toy) is toy
        assert models.register("toy_net")(toy) is toy
        assert jmodels.get_model("toy_net", 7, width=3) == ("toy", 7)
        assert models.get_model("toy_net", 7, width=3) == ("toy", 7)
        assert calls == [(7, {"width": 3})] * 2
        assert "toy_net" in models.available_models()
        assert models.available_models() == jmodels.available_models()
    finally:
        jmodels._REGISTRY.pop("toy_net", None)
        models._REGISTRY.pop("toy_net", None)
    assert len(models.available_models()) == 13
    with pytest.raises(KeyError, match="toy_net"):
        models.get_model("toy_net")


def test_resnet_matches_jax():
    j = jresnet.resnet(18, rngs=nnx.Rngs(0))
    t = carry_weights(j, resnet.resnet(18, device="cpu"), seed=2)
    assert isinstance(t, resnet.ResNet)
    assert t.stage_channels == tuple(j.stage_channels)
    x = _x((1, 64, 64, 3), seed=1)
    want = [np.asarray(f) for f in j(jnp.asarray(x))]
    with torch.no_grad():
        got = [f.numpy() for f in t(torch.from_numpy(x))]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    # the seed draws the parameters: the same seed, the same model
    again = resnet.resnet(18, device="cpu")
    other = resnet.resnet(18, seed=1, device="cpu")
    a, b, c = (m.stem.conv.weight for m in (resnet.resnet(18, device="cpu"),
                                            again, other))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="depth"):
        resnet.resnet(20, device="cpu")


def test_adaptive_pool_copies_its_matrices_once():
    x = torch.from_numpy(_x((2, 12, 18, 4)))
    pool._pool_tensor.cache_clear()
    first = pool.adaptive_avg_pool2d(x, 5)
    misses = pool._pool_tensor.cache_info().misses
    for bins in (5, 5):
        assert torch.equal(pool.adaptive_avg_pool2d(x, bins), first)
    info = pool._pool_tensor.cache_info()
    assert info.misses == misses == 2 and info.hits == 4
    # the bits of the matrices made anew from numpy on every call
    mh = torch.from_numpy(pool._pool_matrix(12, 5))
    mw = torch.from_numpy(pool._pool_matrix(18, 5))
    want = torch.einsum("nhwc,ow->nhoc",
                        torch.einsum("nhwc,oh->nowc", x, mh), mw)
    assert torch.equal(first, want)
    # a bf16 input pools in float32: the float32 matrices are the ones kept
    pool.adaptive_avg_pool2d(x.bfloat16(), 5)
    assert pool._pool_tensor.cache_info().misses == 2
