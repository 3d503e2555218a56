"""PyTorch port, train-mode BatchNorm: the port's `ConvBNAct` and
`folded_1x1_weights` against the JAX package's in float32 on the CPU, same
inputs from numpy seeds, weights carried by `export_torch_state_dict` →
`state_dict_from_jax`. Compared: the output, the gradients (through the
batch statistics) and the running mean and biased running variance after
one and after two forward passes. Tolerance 1e-5: both sides compute in
float32 and differ only in summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu import ops as jops
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.ops import folded_bn as jfolded
from torch_semantic_segmentation_tpu_torch import ops as tops
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax
from torch_semantic_segmentation_tpu_torch.ops.folded_bn import (
    folded_1x1_weights)

from tests.torch_port_util import jax_model_at, jax_x64, randomize_bn

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(j, t, seed):
    """Random BN state on the JAX block, carried into the port's block; both
    in train mode."""
    randomize_bn(j, np.random.default_rng(seed))
    t.load_state_dict(state_dict_from_jax(export_torch_state_dict(j)),
                      strict=True)
    j.train()
    return t.train()


def _jax_grads(j, grads) -> dict:
    """The JAX parameter gradients in the port's layout and names."""
    c = nnx.clone(j)
    nnx.update(c, grads)
    return {k: v for k, v in export_torch_state_dict(c).items()
            if not k.endswith(("running_mean", "running_var"))}


def _stats(t) -> dict:
    return {k: v.numpy() for k, v in t.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("kw", [
    dict(in_ch=3, out_ch=8, kernel_size=3, stride=2, act="relu"),
    dict(in_ch=6, out_ch=6, kernel_size=3, groups=6, act=None),
    dict(in_ch=5, out_ch=7, kernel_size=1, act="relu", use_bias=True),
])
def test_conv_bn_act_train_matches_jax(kw):
    kw = dict(kw)
    args = (kw.pop("in_ch"), kw.pop("out_ch"), kw.pop("kernel_size"))
    j = jops.ConvBNAct(*args, rngs=nnx.Rngs(0), **kw)
    t = _pair(j, tops.ConvBNAct(*args, **kw), seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 2.0, size=(2, 10, 12, args[0])).astype(np.float32)
    want_y = np.asarray(j(jnp.asarray(x)))           # no grad: one update
    ct = rng.normal(size=want_y.shape).astype(np.float32)

    def loss(m, xj):
        return jnp.sum(m(xj) * jnp.asarray(ct))

    xt = torch.from_numpy(x).requires_grad_(True)
    y = t(xt)
    np.testing.assert_allclose(y.detach().numpy(), want_y, **TOL)
    want = export_torch_state_dict(j)
    for k, v in _stats(t).items():                    # after one pass
        np.testing.assert_allclose(v, want[k], err_msg=k, **TOL)

    _, (gm, gx) = nnx.value_and_grad(loss, argnums=(0, 1))(j, jnp.asarray(x))
    (t(xt) * torch.from_numpy(ct)).sum().backward()   # second pass
    want = export_torch_state_dict(j)
    for k, v in _stats(t).items():                    # after two passes
        np.testing.assert_allclose(v, want[k], err_msg=k, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    got = dict(t.named_parameters())
    for k, v in _jax_grads(j, gm).items():
        np.testing.assert_allclose(got[k].grad.numpy(), v, err_msg=k, **TOL)


def test_train_bn_keeps_float64_as_flax_does():
    """flax's batch statistics are at least float32: a float64 input
    keeps float64 (`jax_enable_x64`). The port's train-mode BN did its
    statistics and normalisation in float32 whatever the input, up to
    2.95e-7 off flax's float64 output; both now agree at 1e-12."""
    j = jops.ConvBNAct(3, 8, 3, stride=2, act="relu", rngs=nnx.Rngs(0))
    t = _pair(j, tops.ConvBNAct(3, 8, 3, stride=2, act="relu"), seed=3)
    t = t.double()
    x = np.random.default_rng(4).normal(1.0, 2.0, size=(2, 10, 12, 3))
    with jax_x64():
        j64 = jax_model_at(j, jnp.float64)
        j64.train()
        want = np.asarray(j64(jnp.asarray(x)))
        stats = export_torch_state_dict(j64)
    y = t(torch.from_numpy(x))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-12,
                               atol=1e-12)
    for k, v in _stats(t).items():
        np.testing.assert_allclose(v, stats[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def test_train_bn_stores_biased_variance():
    """flax's running variance is the biased batch variance (torch's own
    BatchNorm would store the unbiased one)."""
    bn = tops.make_norm(4).train()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 2, 3, 4)).astype(np.float32))
    bn(x)
    biased = x.reshape(-1, 4).var(dim=0, unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               (0.9 + 0.1 * biased).numpy(), **TOL)


@pytest.mark.parametrize("use_bias", [False, True])
def test_folded_1x1_weights_matches_jax(use_bias):
    j = jops.ConvBNAct(6, 24, 1, act="relu", use_bias=use_bias,
                       rngs=nnx.Rngs(0))
    t = _pair(j, tops.ConvBNAct(6, 24, 1, act="relu", use_bias=use_bias),
              seed=5)
    rng = np.random.default_rng(6)
    x = rng.normal(0.5, 1.5, size=(2, 8, 10, 6)).astype(np.float32)
    a = rng.normal(size=(6, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)

    def loss(m, xj):
        w_f, b_f = jfolded.folded_1x1_weights(m.conv, m.bn, xj)
        return jnp.sum(w_f * a) + jnp.sum(b_f * b), (w_f, b_f)

    (_, (w_want, b_want)), (gm, gx) = nnx.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(j, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    w_got, b_got = folded_1x1_weights(t.conv, t.bn, xt)
    assert w_got.dtype == b_got.dtype == torch.float32
    np.testing.assert_allclose(w_got.detach().numpy(), np.asarray(w_want), **TOL)
    np.testing.assert_allclose(b_got.detach().numpy(), np.asarray(b_want), **TOL)
    ((w_got * torch.from_numpy(a)).sum()
     + (b_got * torch.from_numpy(b)).sum()).backward()
    want = export_torch_state_dict(j)
    for k, v in _stats(t).items():
        np.testing.assert_allclose(v, want[k], err_msg=k, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    got = dict(t.named_parameters())
    for k, v in _jax_grads(j, gm).items():
        np.testing.assert_allclose(got[k].grad.numpy(), v, err_msg=k, **TOL)


def test_train_bn_cumulative_average_without_momentum():
    """momentum=None keeps torch's cumulative average of the batch stats."""
    bn = tops.make_norm(3).train()
    bn.momentum = None
    bn.reset_running_stats()
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.normal(size=(2, 4, 5, 3)).astype(np.float32))
          for _ in range(3)]
    for x in xs:
        bn(x)
    flat = [x.reshape(-1, 3) for x in xs]
    np.testing.assert_allclose(
        bn.running_mean.numpy(),
        torch.stack([f.mean(0) for f in flat]).mean(0).numpy(), **TOL)
    np.testing.assert_allclose(
        bn.running_var.numpy(),
        torch.stack([f.var(0, unbiased=False) for f in flat]).mean(0).numpy(),
        **TOL)
