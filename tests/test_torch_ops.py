"""PyTorch port, ops layer: each module and function against its JAX
counterpart on the CPU, float32, same inputs from numpy seeds, weights
carried by `export_torch_state_dict` → `state_dict_from_jax`. Tolerance
1e-5: both sides compute in float32 and differ only in summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu import ops as jops
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.data.transforms import (
    normalize_batch as j_normalize_batch)
from torch_semantic_segmentation_tpu.ops import fold as jfold
from torch_semantic_segmentation_tpu_torch import ops as tops
from torch_semantic_segmentation_tpu_torch.data.transforms import (
    normalize_batch)
from torch_semantic_segmentation_tpu_torch.ops import fold as tfold
from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout

from tests.torch_port_util import carry_weights as _pair

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _run_both(jmodule, tmodule, x):
    want = np.asarray(jmodule(jnp.asarray(x)))
    with torch.no_grad():
        got = tmodule(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("kw", [
    dict(in_ch=3, out_ch=8, kernel_size=3, stride=2, act="relu"),
    dict(in_ch=6, out_ch=6, kernel_size=3, dilation=2, groups=6, act=None),
    dict(in_ch=5, out_ch=7, kernel_size=1, act=None, use_bias=True),
])
def test_conv_bn_act(kw):
    kw = dict(kw)
    args = (kw.pop("in_ch"), kw.pop("out_ch"), kw.pop("kernel_size"))
    j = jops.ConvBNAct(*args, rngs=nnx.Rngs(0), **kw)
    t = _pair(j, tops.ConvBNAct(*args, **kw))
    got, want = _run_both(j, t, _x((2, 12, 16, args[0])))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stride,fold", [(1, False), (2, False), (1, True)])
def test_separable_conv(stride, fold):
    """Unfolded eval, and folded (the port then runs the fused kernel's
    plain version; the JAX package on the CPU runs the unfused pair)."""
    j = jops.SeparableConv(6, 10, 3, stride=stride, rngs=nnx.Rngs(0))
    t = _pair(j, tops.SeparableConv(6, 10, 3, stride=stride))
    if fold:
        assert jfold.fold_batchnorm(j) == 2 and tfold.fold_batchnorm(t) == 2
    got, want = _run_both(j, t, _x((2, 8, 12, 6)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stride,cin,cout", [(1, 8, 8), (2, 8, 12)])
def test_inverted_residual(stride, cin, cout):
    j = jops.InvertedResidual(cin, cout, stride=stride, rngs=nnx.Rngs(0))
    t = _pair(j, tops.InvertedResidual(cin, cout, stride=stride))
    got, want = _run_both(j, t, _x((2, 8, 12, cin)))
    np.testing.assert_allclose(got, want, **TOL)


def test_pyramid_pooling():
    j = jops.PyramidPooling(16, 12, rngs=nnx.Rngs(0))
    t = _pair(j, tops.PyramidPooling(16, 12))
    got, want = _run_both(j, t, _x((2, 10, 14, 16)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("out", [1, 2, 3, 6, (4, 5)])
def test_adaptive_avg_pool2d(out):
    x = _x((2, 10, 14, 3))
    want = np.asarray(jops.adaptive_avg_pool2d(jnp.asarray(x), out))
    got = tops.adaptive_avg_pool2d(torch.from_numpy(x), out).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_global_avg_pool():
    x = _x((2, 5, 7, 3))
    want = np.asarray(jops.global_avg_pool(jnp.asarray(x)))
    got = tops.global_avg_pool(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(32, 48), (5, 7), (8, 12)])
def test_resize_bilinear(align_corners, size):
    x = _x((2, 8, 12, 3))
    want = np.asarray(jops.resize_bilinear(jnp.asarray(x), size,
                                           align_corners=align_corners))
    got = tops.resize_bilinear(torch.from_numpy(x), size,
                               align_corners=align_corners).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_resize_bilinear_matches_torch_interpolate():
    x = _x((2, 8, 12, 3))
    for ac in (False, True):
        got = tops.resize_bilinear(torch.from_numpy(x), (32, 40),
                                   align_corners=ac)
        want = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), (32, 40),
            mode="bilinear", align_corners=ac).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_argmax(align_corners):
    x = _x((2, 8, 16, 19))
    want = np.asarray(jops.resize_argmax(jnp.asarray(x), (64, 128),
                                         align_corners=align_corners))
    got = tops.resize_argmax(torch.from_numpy(x), (64, 128),
                             align_corners=align_corners)
    assert got.dtype == torch.uint8 and got.shape == (2, 64, 128)
    assert (got.numpy() != want).mean() < 1e-3


def test_fold_batchnorm():
    """Folded weights and biases equal the JAX fold, a bias is created
    where there was none, and `bn` becomes None."""
    j = jops.InvertedResidual(8, 8, rngs=nnx.Rngs(0))
    t = _pair(j, tops.InvertedResidual(8, 8))
    assert t.expand.conv.bias is None
    assert jfold.fold_batchnorm(j) == 3
    assert tfold.fold_batchnorm(t) == 3
    assert tfold.fold_batchnorm(t) == 0
    for name in ("expand", "dw", "project"):
        blk = getattr(t, name)
        assert blk.bn is None and blk.conv.bias is not None
    sd = export_torch_state_dict(j)
    for key, value in t.state_dict().items():
        np.testing.assert_allclose(value.numpy(), sd[key], **TOL)
    got, want = _run_both(j, t, _x((2, 8, 12, 8)))
    np.testing.assert_allclose(got, want, **TOL)


def test_fold_requires_eval():
    t = tops.ConvBNAct(3, 4, 3)
    with pytest.raises(ValueError, match="eval"):
        tfold.fold_conv_bn_act(t.train())


def test_compute_dtype_casts_at_call_time():
    t = tops.ConvBNAct(3, 4, 3, compute_dtype=torch.bfloat16).eval()
    y = t(torch.from_numpy(_x((1, 8, 8, 3))))
    assert y.dtype == torch.bfloat16
    assert t.conv.weight.dtype == torch.float32


def test_dropout():
    x = torch.ones(4, 64, 64, 8)
    d = Dropout(0.25, generator=torch.Generator().manual_seed(0))
    assert d.eval()(x) is x
    y1 = d.train()(x)
    kept = (y1 != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    assert torch.allclose(y1[y1 != 0], torch.full_like(y1[y1 != 0], 1 / 0.75))
    d2 = Dropout(0.25, generator=torch.Generator().manual_seed(0)).train()
    assert torch.equal(d2(x), y1)


def test_normalize_batch():
    imgs = np.random.default_rng(0).integers(0, 256, (2, 6, 8, 3), np.uint8)
    want = np.asarray(j_normalize_batch(jnp.asarray(imgs)))
    got = normalize_batch(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
