"""PyTorch port, ENet (BASELINE config 1) and its ops on the CPU against
the JAX package, in float32, the JAX weights carried by
`export_torch_state_dict` → `state_dict_from_jax` and loaded with
strict=True, the JAX package on its plain path (`TPU_SEG_PACKED_ENET=0`,
`TPU_SEG_PACKED_ENET_BODY=0`):

- `PReLU` and `ConvBNAct(prelu=True)`, value and gradients at 1e-5, with
  exact zeros in x: d/dx 1 and d/da 0 there, where `F.prelu` takes the
  slope;
- `max_pool2x2_with_indices` and `max_unpool2x2` on tied windows: values,
  indices and gradients at 1e-5; a tied window splits its gradient
  equally, which `nn.MaxPool2d(return_indices=True)` does not;
- spatial dropout draws one mask value an (n, c);
- `compute_class_weights` equal to the JAX function's;
- ENet at 2x64x64: eval logits at 1e-4 of scale, and 3 SGD steps with the
  class-weighted CE at rtol = atol = 1e-4 (dropout rate 0 on both sides:
  the frameworks draw different masks); one `remat=True` step bit for bit
  against the step without it, with ENet's own dropout rates."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu.data import class_weights as jcw
from torch_semantic_segmentation_tpu.losses import (
    cross_entropy_loss as j_ce_loss)
from torch_semantic_segmentation_tpu.models.enet import enet as j_enet
from torch_semantic_segmentation_tpu.ops import conv as jconv
from torch_semantic_segmentation_tpu.ops import pool as jpool
from torch_semantic_segmentation_tpu_torch.data import class_weights
from torch_semantic_segmentation_tpu_torch.losses import cross_entropy_loss
from torch_semantic_segmentation_tpu_torch.models import get_model
from torch_semantic_segmentation_tpu_torch.ops import (
    ConvBNAct, PReLU, max_pool2x2_with_indices, max_unpool2x2)
from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout

from torch_port_util import (
    carry_weights, remat_step_is_bit_exact, sgd_steps_match_jax)

torch.set_num_threads(2)

N, H, W, C = 2, 64, 64, 5


@pytest.fixture(autouse=True)
def _plain_jax_path(monkeypatch):
    monkeypatch.setenv("TPU_SEG_PACKED_ENET", "0")
    monkeypatch.setenv("TPU_SEG_PACKED_ENET_BODY", "0")


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _with_zeros(shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x.reshape(-1)[::5] = 0.0
    return x


def test_prelu_matches_jax_with_zeros():
    x = _with_zeros((2, 5, 6, 4), 0)
    a = np.array([0.25, -0.5, 1.5, 0.1], np.float32)
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    jp = jconv.PReLU(4)
    jp.alpha[...] = jnp.asarray(a)
    jy, vjp = jax.vjp(lambda xx, aa: jnp.where(xx >= 0, xx, aa * xx),
                      jnp.asarray(x), jnp.asarray(a))
    np.testing.assert_array_equal(np.asarray(jp(jnp.asarray(x))), jy)
    jdx, jda = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    tp = PReLU(4)
    with torch.no_grad():
        tp.weight.copy_(torch.from_numpy(a))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tp(xt)
    y.backward(torch.from_numpy(g))
    _close(y.detach().numpy(), np.asarray(jy), 1e-5)
    _close(xt.grad.numpy(), jdx, 1e-5)
    _close(tp.weight.grad.numpy(), jda, 1e-5)
    zero = x == 0
    np.testing.assert_array_equal(xt.grad.numpy()[zero], g[zero])
    # F.prelu's backward takes the slope at x = 0
    xf = torch.from_numpy(x).requires_grad_(True)
    torch.nn.functional.prelu(xf.permute(0, 3, 1, 2),
                              torch.from_numpy(a)).permute(0, 2, 3, 1
                                                           ).backward(
        torch.from_numpy(g))
    assert not np.allclose(xf.grad.numpy()[zero], g[zero])


@pytest.mark.parametrize("kernel,padding,stride", [
    (1, 0, 1), (2, 0, 2), ((5, 1), (2, 0), 1)])
def test_convbnact_prelu_matches_jax(kernel, padding, stride):
    j = jconv.ConvBNAct(6, 4, kernel, stride=stride, padding=padding,
                        prelu=True, rngs=nnx.Rngs(0))
    j.act.alpha[...] = jnp.asarray(np.linspace(-0.5, 0.5, 4, dtype=np.float32))
    t = ConvBNAct(6, 4, kernel, stride=stride, padding=padding, prelu=True)
    carry_weights(j, t, seed=2)
    assert t.act_name == "prelu"
    x = np.random.default_rng(3).normal(size=(2, 8, 10, 6)).astype(np.float32)
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(j(jnp.asarray(x))), 1e-5)


def _tied(seed):
    """Values on a coarse grid, so that many 2x2 windows hold ties; one
    window all equal."""
    x = np.random.default_rng(seed).integers(0, 3, (2, 6, 8, 3)).astype(
        np.float32)
    x[0, :2, :2, 0] = 1.0
    return x


def test_max_pool_with_indices_and_unpool_match_jax_on_ties():
    x = _tied(4)
    g = np.random.default_rng(5).normal(size=(2, 3, 4, 3)).astype(np.float32)

    jv, ji = jpool.max_pool2x2_with_indices(jnp.asarray(x))
    jdx = np.asarray(jax.grad(lambda xx: jnp.sum(
        jpool.max_pool2x2_with_indices(xx)[0] * g))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    tv, ti = max_pool2x2_with_indices(xt)
    (tv * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(tv.detach().numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(xt.grad.numpy(), jdx, 1e-5)
    # the all-equal window: index 0, a quarter of the gradient each
    assert int(ti[0, 0, 0, 0]) == 0
    np.testing.assert_allclose(xt.grad.numpy()[0, :2, :2, 0],
                               np.full((2, 2), g[0, 0, 0, 0] / 4), rtol=1e-6)
    # torch's MaxPool2d gives a tied window's gradient to one element
    xm = torch.from_numpy(x).requires_grad_(True)
    mv, mi = torch.nn.MaxPool2d(2, return_indices=True)(
        xm.permute(0, 3, 1, 2))
    (mv.permute(0, 2, 3, 1) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(mv.permute(0, 2, 3, 1).detach().numpy(),
                                  np.asarray(jv))
    assert not np.allclose(xm.grad.numpy(), jdx, rtol=1e-5, atol=1e-6)

    # unpool with those indices (from another tensor, as ENet's decoder)
    u = np.random.default_rng(6).normal(size=(2, 3, 4, 3)).astype(np.float32)
    gu = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    ju, uvjp = jax.vjp(lambda uu: jpool.max_unpool2x2(uu, ji), jnp.asarray(u))
    ut = torch.from_numpy(u).requires_grad_(True)
    tu = max_unpool2x2(ut, ti)
    tu.backward(torch.from_numpy(gu))
    np.testing.assert_array_equal(tu.detach().numpy(), np.asarray(ju))
    _close(ut.grad.numpy(), np.asarray(uvjp(jnp.asarray(gu))[0]), 1e-5)


def test_spatial_dropout_draws_one_value_a_channel():
    gen = torch.Generator().manual_seed(0)
    d = Dropout(0.5, broadcast_dims=(1, 2), generator=gen).train()
    y = d(torch.ones(3, 6, 7, 16))
    kept = (y != 0)
    # each (n, c) map is kept or dropped whole
    assert torch.equal(kept.all(dim=(1, 2)), kept.any(dim=(1, 2)))
    assert 0 < int(kept[:, 0, 0].sum()) < 48
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    ones = torch.ones(2, 3, 3, 4)
    assert torch.equal(d.eval()(ones), ones)


def test_compute_class_weights_matches_jax():
    rng = np.random.default_rng(8)
    data = []
    for _ in range(3):
        lbl = rng.integers(0, 7, (16, 20)).astype(np.uint8)
        lbl[:3] = 255
        data.append((None, lbl))
    lut = np.arange(256, dtype=np.uint8)
    lut[6] = 255
    for kw in ({}, {"label_lut": lut}, {"max_samples": 2, "seed": 1}):
        want = jcw.compute_class_weights(data, C + 2, **kw)
        got = class_weights.compute_class_weights(data, C + 2, **kw)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _models():
    j = j_enet(C, rngs=nnx.Rngs(0))
    t = get_model("enet", C, device="cpu")
    for _, m in nnx.iter_graph(j):
        if isinstance(m, nnx.Dropout):
            m.rate = 0.0
    for m in t.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return j, t


def _batches(steps, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        x = rng.normal(size=(N, H, W, 3)).astype(np.float32)
        y = rng.integers(0, C, (N, H, W)).astype(np.int32)
        y[:, :4, :9] = 255
        out.append((x, y))
    return out


def test_enet_eval_logits_match_jax():
    j, t = _models()
    carry_weights(j, t, seed=10)
    x = _batches(1)[0][0]
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    assert got.shape == (N, H, W, C)
    _close(got, np.asarray(j(jnp.asarray(x))), 1e-4)


def test_enet_class_weighted_sgd_steps_match_jax():
    j, t = _models()
    batches = _batches(3)
    cw = class_weights.compute_class_weights(batches, C)
    sgd_steps_match_jax(
        j, t, functools.partial(j_ce_loss, class_weights=jnp.asarray(cw)),
        functools.partial(cross_entropy_loss,
                          class_weights=torch.from_numpy(cw)), batches)


def test_enet_remat_step_equals_the_step_without_remat():
    x, y = (torch.from_numpy(a) for a in _batches(1, seed=11)[0])
    model = get_model("enet", C, device="cpu")
    assert {m.rate for m in model.modules() if isinstance(m, Dropout)} == {
        0.01, 0.1}
    remat_step_is_bit_exact(lambda: get_model("enet", C, device="cpu"),
                            cross_entropy_loss, x, y)
