"""PyTorch port, the bias-free depthwise 3×3 (K6) on the CPU, where its
wrappers run the plain versions:

- against the JAX package's Pallas kernel in interpret mode
  (`pallas_dw.depthwise_conv3x3(..., interpret=True)`) at the `FAST_CASES`
  of `test_pallas_dw.py`, bf16 x and the float32 kernel the routed path
  passes: the output and dx within one bf16 step of their scale (2^-8:
  float32 sums in another order may round to the other neighbour), dk at
  a relative L2 error of 1e-5 (float32 sums over every pixel);
- a float32 case against `depthwise_conv3x3_reference` (lax) and its
  autodiff at 1e-5;
- `LearningToDownsample` in train mode, bf16, with both packages routing
  the stride-2 depthwise convs (the JAX package's opt-in switch, its pixel
  floor and the packed LDS set as `test_torch_mbconv.py` sets its own),
  against the JAX module: output, dx and running means at the bars of
  `test_torch_mbconv.py`, each parameter's gradient at its bar for a
  noisy one (4e-2): three train-mode BNs in bf16 deep, the two packages'
  gradients read up to 2.1e-2 apart with neither routing and 2.7e-2 with
  both, while a port that kept the bf16-rounded kernel of the unrouted
  conv reads 8.6e-2 to 0.27 apart from the routed JAX module on every
  gradient (a probe on this file's inputs);
- the routing predicate's truth table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.models.fastscnn import (
    LearningToDownsample as JLearningToDownsample)
from torch_semantic_segmentation_tpu.ops import pallas_dw
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax
from torch_semantic_segmentation_tpu_torch.models.fastscnn import (
    LearningToDownsample)
from torch_semantic_segmentation_tpu_torch.ops import conv as tconv
from torch_semantic_segmentation_tpu_torch.ops import depthwise

from tests.torch_port_util import randomize_bn

torch.set_num_threads(2)

FAST_CASES = [((2, 16, 32, 32), 2), ((1, 8, 64, 48), 1)]


def _make(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=(3, 3, shape[-1])).astype(np.float32)
    return x, k


def _out_shape(shape, stride):
    n, h, w, c = shape
    return (n, (h - 1) // stride + 1, (w - 1) // stride + 1, c)


def _jax_fwd_grads(fn, x, k, ct, dtype):
    def f(x, k):
        return jnp.sum(fn(x, k).astype(jnp.float32) * ct)
    args = (jnp.asarray(x, dtype), jnp.asarray(k))
    y = np.asarray(fn(*args), np.float32)
    gx, gk = jax.grad(f, argnums=(0, 1))(*args)
    return y, np.asarray(gx, np.float32), np.asarray(gk, np.float32)


def _port_fwd_grads(x, k, stride, ct, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    y = depthwise.depthwise_conv3x3(xt, kt, stride)
    assert y.dtype == dtype
    (y.float() * torch.from_numpy(ct)).sum().backward()
    assert xt.grad.dtype == dtype and kt.grad.dtype == torch.float32
    return (y.detach().float().numpy(), xt.grad.float().numpy(),
            kt.grad.numpy())


def _rel(got, want):
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-9)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("shape,stride", FAST_CASES)
def test_depthwise_matches_jax_kernel(shape, stride):
    x, k = _make(shape)
    ct = np.cos(np.arange(np.prod(_out_shape(shape, stride)),
                          dtype=np.float32)).reshape(_out_shape(shape, stride))
    want = _jax_fwd_grads(
        lambda a, b: pallas_dw.depthwise_conv3x3(a, b, stride=stride,
                                                 interpret=True),
        x, k, ct, jnp.bfloat16)
    got = _port_fwd_grads(x, k, stride, ct, torch.bfloat16)
    for name, g, r in zip(("y", "dx", "dk"), got, want):
        assert g.shape == r.shape, name
    assert _rel(got[0], want[0]) <= 2.0 ** -8
    assert _rel(got[1], want[1]) <= 2.0 ** -8
    assert _rel_l2(got[2], want[2]) <= 1e-5


@pytest.mark.parametrize("stride", [1, 2])
def test_float32_matches_lax_reference(stride):
    shape = (2, 9, 14, 20)                  # odd H, C off 8
    x, k = _make(shape, seed=1)
    oshape = _out_shape(shape, stride)
    ct = np.random.default_rng(2).normal(size=oshape).astype(np.float32)
    want = _jax_fwd_grads(
        lambda a, b: pallas_dw.depthwise_conv3x3_reference(a, b,
                                                           stride=stride),
        x, k, ct, jnp.float32)
    got = _port_fwd_grads(x, k, stride, ct, torch.float32)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


def test_plain_backward_is_the_transpose_of_the_forward():
    """<g, conv(x)> = <dx(g), x> = <dk, k> at stride 2 with odd sizes, in
    float64 where the forward and both halves of the backward sum
    exactly alike."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 7, 9, 5)))
    k = torch.from_numpy(rng.normal(size=(3, 3, 5)))
    g = torch.from_numpy(rng.normal(size=(1, 4, 5, 5)))
    y = depthwise.depthwise3x3_reference(x, k, 2).double()
    dx, dk = depthwise.depthwise3x3_reference_backward(x, k, g, 2)
    lhs = float((g * y).sum())
    assert abs(lhs - float((dx.double() * x).sum())) < 1e-5
    assert abs(lhs - float((dk.double() * k).sum())) < 1e-5


def test_learning_to_downsample_train_bf16_matches_routed_jax(monkeypatch):
    monkeypatch.setenv("TPU_SEG_PALLAS_DW_MIN_PX", "0")
    monkeypatch.setenv("FASTSCNN_PACKED_LDS", "0")
    monkeypatch.setattr(pallas_dw, "routing_enabled", lambda: True)
    real = pallas_dw.depthwise_conv3x3
    port_real = depthwise.depthwise_conv3x3
    j_calls, t_calls = [], []

    def interp_kernel(x, k, *, stride=1, interpret=False):
        j_calls.append((x.shape, stride))
        return real(x, k, stride=stride, interpret=True)

    def spy(x, k, stride):
        t_calls.append((tuple(x.shape), stride))
        return port_real(x, k, stride)

    monkeypatch.setattr(pallas_dw, "depthwise_conv3x3", interp_kernel)
    monkeypatch.setattr(depthwise, "depthwise_conv3x3", spy)
    monkeypatch.setattr(tconv, "DEPTHWISE_MIN_PX", 0)

    j = JLearningToDownsample(3, (32, 48, 64), dtype=jnp.bfloat16,
                              rngs=nnx.Rngs(0))
    t = LearningToDownsample(3, (32, 48, 64), compute_dtype=torch.bfloat16)
    randomize_bn(j, np.random.default_rng(4))
    t.load_state_dict(state_dict_from_jax(export_torch_state_dict(j)),
                      strict=True)
    j.train()
    t.train()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    ct = rng.normal(size=(2, 4, 8, 64)).astype(np.float32)

    def loss(m, xx):
        y = m(xx)
        return jnp.sum(y.astype(jnp.float32) * ct), y

    (_, want_y), (gm, gx) = nnx.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(j, xj)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    xt.requires_grad_(True)
    y = t(xt)
    (y.float() * torch.from_numpy(ct)).sum().backward()
    assert [s for _, s in j_calls] == [2, 2]
    assert t_calls == [((2, 16, 32, 32), 2), ((2, 8, 16, 48), 2)]

    assert y.dtype == torch.bfloat16
    assert _rel(y.detach().float().numpy(), np.asarray(want_y, np.float32)) \
        < 2e-2
    assert _rel(xt.grad.float().numpy(), np.asarray(gx, np.float32)) < 2e-2
    c = nnx.clone(j)
    nnx.update(c, gm)
    got = dict(t.named_parameters())
    for key, r in export_torch_state_dict(c).items():
        if key.endswith(("running_mean", "running_var")):
            continue
        assert _rel(got[key].grad.float().numpy(), r) < 4e-2, key
    for name in ("conv", "ds1.dw", "ds1.pw", "ds2.dw", "ds2.pw"):
        tm = t.get_submodule(name).bn
        jm = j
        for part in name.split("."):
            jm = getattr(jm, part)
        np.testing.assert_allclose(tm.running_mean.numpy(),
                                   np.asarray(jm.bn.mean[...], np.float32),
                                   rtol=1e-2, atol=1e-3, err_msg=name)


def _block(**kw):
    args = dict(stride=2, groups=8, act="relu", compute_dtype=torch.bfloat16)
    args.update(kw)
    return tconv.ConvBNAct(8, 8, 3, **args)


# (what changes, ConvBNAct arguments, x dtype, pixel floor, routed)
ROUTING_CASES = [
    ("stride 2 bf16", {}, torch.bfloat16, 0, True),
    ("stride 2 float32", {"compute_dtype": None}, torch.float32, 0, True),
    ("stride 1", {"stride": 1}, torch.bfloat16, 0, False),
    ("bias", {"use_bias": True}, torch.bfloat16, 0, False),
    ("dilation 2", {"dilation": 2}, torch.bfloat16, 0, False),
    ("not depthwise", {"groups": 1}, torch.bfloat16, 0, False),
    ("below the floor", {}, torch.bfloat16, 2 * 16 * 32 + 1, False),
    ("at the floor", {}, torch.bfloat16, 2 * 16 * 32, True),
    ("compute dtype bf16, x float32", {}, torch.float32, 0, False),
    ("compute dtype float32, x bf16", {"compute_dtype": torch.float32},
     torch.bfloat16, 0, False),
    ("float16", {"compute_dtype": None}, torch.float16, 0, False),
]


@pytest.mark.parametrize("what,kw,dtype,floor,routed", ROUTING_CASES,
                         ids=[c[0] for c in ROUTING_CASES])
def test_routing_predicate(monkeypatch, what, kw, dtype, floor, routed):
    monkeypatch.setattr(tconv, "DEPTHWISE_MIN_PX", floor)
    block = _block(**kw)
    x = torch.zeros((2, 16, 32, 8), dtype=dtype)
    assert (block._maybe_depthwise(x) is not None) == routed


def test_routed_conv_matches_plain_conv_in_float32():
    """The routed stride-2 conv and the plain one agree in float32 (the
    float32 kernel is then the conv's own)."""
    block = _block(compute_dtype=None)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 16, 32, 8)).astype(np.float32))
    k = block.conv.weight.reshape(8, 3, 3).permute(1, 2, 0)
    torch.testing.assert_close(depthwise.depthwise_conv3x3(x, k, 2),
                               block.conv(x), rtol=1e-5, atol=1e-5)
