"""PyTorch port, the fused expand → ReLU → depthwise op (K2) on the CPU,
where its wrapper runs the plain version:

- against the JAX package's Pallas kernel in interpret mode
  (`fused_expand_dw(..., stride, True)`) at the `FAST_CASES` of
  `test_pallas_mbconv.py`, forward and dx, dW′, db′, dk. Same rounding
  points; float32 sums in another order can flip a bf16 rounding of `e`,
  of the output or of `dem`: the output within one bf16 step of its scale
  (2^-8), each gradient within 2^-7 of its scale;
- one Ce=576 case (which the TPU kernel does not take) against
  `expand_dw_reference` and its autodiff, which round elsewhere (a bf16
  conv and its bf16 transposes): the bars of `test_pallas_mbconv.py`;
- `InvertedResidual` in train mode, bf16, against the JAX block routed
  through the interpret kernel (patched as `test_pallas_mbconv.py` does):
  output, gradients and the dw BN's running mean, with random BN
  parameters (at scale 1 and bias 0 the ReLU makes the expand BN scale's
  true gradient vanish, and only rounding noise is left to compare).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.ops import blocks as jblocks
from torch_semantic_segmentation_tpu.ops import pallas_mbconv
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax
from torch_semantic_segmentation_tpu_torch.ops import blocks as tblocks
from torch_semantic_segmentation_tpu_torch.ops import mbconv

from tests.torch_port_util import randomize_bn

torch.set_num_threads(2)

FAST_CASES = [((2, 16, 32, 16), 128, 1), ((1, 8, 64, 24), 256, 2)]


def _make(shape, ce, seed=0):
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    x = rng.normal(size=shape).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)   # bf16 values
    wt = (rng.normal(size=(c, ce)) * 0.3).astype(np.float32)
    b = rng.normal(size=(ce,)).astype(np.float32)
    k = rng.normal(size=(3, 3, ce)).astype(np.float32)
    return x, wt, b, k


def _cotangent(shape):
    return np.cos(np.arange(np.prod(shape), dtype=np.float32)).reshape(shape)


def _jax_fwd_grads(fn, x, wt, b, k, ct):
    def f(x, wt, b, k):
        return jnp.sum(fn(x, wt, b, k).astype(jnp.float32) * ct)
    args = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt), jnp.asarray(b),
            jnp.asarray(k))
    y = np.asarray(fn(*args), np.float32)
    grads = jax.grad(f, argnums=(0, 1, 2, 3))(*args)
    return y, [np.asarray(g, np.float32) for g in grads]


def _port_fwd_grads(x, wt, b, k, stride, ct):
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (wt, b, k)]
    y = mbconv.fused_expand_dw(xt, *ts, stride)
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(ct)).sum().backward()
    assert xt.grad.dtype == torch.bfloat16
    return (y.detach().float().numpy(),
            [xt.grad.float().numpy()] + [t.grad.numpy() for t in ts])


def _rel(got, want):
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-9)


@pytest.mark.parametrize("shape,ce,stride", FAST_CASES)
def test_fused_expand_dw_matches_jax_kernel(shape, ce, stride):
    x, wt, b, k = _make(shape, ce)
    n, h, w, _ = shape
    ct = _cotangent((n, h // stride, w // stride, ce))
    want_y, want_g = _jax_fwd_grads(
        lambda *a: pallas_mbconv.fused_expand_dw(*a, stride, True),
        x, wt, b, k, ct)
    got_y, got_g = _port_fwd_grads(x, wt, b, k, stride, ct)
    assert got_y.shape == want_y.shape
    assert _rel(got_y, want_y) <= 2.0 ** -8
    for name, g, r in zip(["dx", "dw", "db", "dk"], got_g, want_g):
        assert g.shape == r.shape, name
        assert _rel(g, r) <= 2.0 ** -7, (name, _rel(g, r))


def test_wide_block_against_jax_reference():
    """Ce=576, the width of the FastSCNN stage-2 tail, at stride 1."""
    x, wt, b, k = _make((1, 6, 10, 96), 576, seed=1)
    ct = _cotangent((1, 6, 10, 576))
    want_y, want_g = _jax_fwd_grads(
        lambda *a: pallas_mbconv.expand_dw_reference(*a, 1), x, wt, b, k, ct)
    got_y, got_g = _port_fwd_grads(x, wt, b, k, 1, ct)
    np.testing.assert_allclose(got_y, want_y, rtol=2e-2, atol=5e-2)
    for name, g, r in zip(["dx", "dw", "db", "dk"], got_g, want_g):
        assert _rel(g, r) < 2e-2, (name, _rel(g, r))


def test_plain_version_pads_e_not_x():
    """Outside the image the expanded tensor is 0, not relu(b′): with x = 0
    the centre tap alone sees relu(b′) at a corner."""
    b = torch.full((4,), 2.0)
    k = torch.zeros(3, 3, 4)
    k[0, 0] = 1.0                       # the up-left neighbour
    y = mbconv.expand_dw_reference(torch.zeros(1, 3, 3, 2), torch.zeros(2, 4),
                                   b, k, 1)
    assert float(y[0, 0, 0, 0]) == 0.0  # padding
    assert float(y[0, 1, 1, 0]) == 2.0  # an image pixel


def _near_zero_inputs(seed, n, h, w, cin, ce):
    """Every pixel holds one x vector and b′ = −float32(x·W′), so that each
    channel's exact pre-activation x·W′ + b′ is the float32 rounding error
    of x·W′: a float32 sum in any order can land on either side of 0.
    Returns x, W′, b′, k, g (torch, bf16 x and g; stride 1) and the exact
    pre-activations (numpy float64, (Ce,))."""
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(rng.normal(size=cin).astype(np.float32)).to(
        torch.bfloat16)
    wt = torch.from_numpy((rng.normal(size=(cin, ce)) * 0.3).astype(
        np.float32)).to(torch.bfloat16).float()
    s = x0.double().numpy() @ wt.double().numpy()
    b = torch.from_numpy(-s.astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(3, 3, ce)).astype(np.float32))
    x = x0.reshape(1, 1, 1, cin).expand(n, h, w, cin).contiguous()
    g = torch.from_numpy(rng.normal(size=(n, h, w, ce)).astype(
        np.float32)).to(torch.bfloat16)
    return x, wt, b, k, g, s + b.double().numpy()


@pytest.mark.parametrize("cin,ce,seed", [(16, 64, 0), (64, 128, 1),
                                         (128, 96, 2), (20, 70, 3)])
def test_plain_backward_masks_by_the_exact_sign(cin, ce, seed):
    """The plain backward's mask e > 0 follows the exact pre-activation's
    sign, as the backward kernel's does, at elements whose float32 sum lies
    within its rounding error of 0: db′ is 0 exactly on the channels whose
    exact pre-activation is at most 0, and elsewhere the float64 sum of de
    (to 1e-5 of its scale); the channels of both signs occur."""
    n, h, w = 2, 6, 10
    x, wt, b, k, g, exact = _near_zero_inputs(seed, n, h, w, cin, ce)
    assert (exact > 0).any() and (exact < 0).any()
    _, _, db, _ = mbconv.expand_dw_reference_backward(x, wt, b, k, g, 1)
    gp = np.pad(g.double().numpy(), ((0, 0), (1, 1), (1, 1), (0, 0)))
    de = sum(gp[:, 2 - dh:2 - dh + h, 2 - dw:2 - dw + w]
             * k.double().numpy()[dh, dw] for dh in range(3) for dw in range(3))
    want = np.where(exact > 0, de.sum(axis=(0, 1, 2)), 0.0)
    got = db.double().numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


@pytest.mark.parametrize("stride", [1, 2])
def test_inverted_residual_train_bf16_matches_routed_jax_block(
        monkeypatch, stride):
    monkeypatch.setenv("TPU_SEG_PALLAS_MBCONV", "1")
    monkeypatch.setenv("TPU_SEG_PALLAS_MBCONV_MIN_PX", "0")
    monkeypatch.setenv("TPU_SEG_FOLDED_BN", "1")
    real = pallas_mbconv.fused_expand_dw
    j_calls, t_calls = [], []

    def interp_kernel(x, w, b, k, s, interpret=False):
        j_calls.append(s)
        return real(x, w, b, k, s, True)

    def spy(x, w, b, k, s):
        t_calls.append(s)
        return mbconv.fused_expand_dw(x, w, b, k, s)

    monkeypatch.setattr(pallas_mbconv, "fused_expand_dw", interp_kernel)
    monkeypatch.setattr(tblocks, "fused_expand_dw", spy)

    cout = 16 if stride == 1 else 24
    j = jblocks.InvertedResidual(16, cout, stride=stride, expand_ratio=8,
                                 dtype=jnp.bfloat16, rngs=nnx.Rngs(0))
    t = tblocks.InvertedResidual(16, cout, stride=stride, expand_ratio=8,
                                 compute_dtype=torch.bfloat16)
    randomize_bn(j, np.random.default_rng(2))
    t.load_state_dict(state_dict_from_jax(export_torch_state_dict(j)),
                      strict=True)
    j.train()
    t.train()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 32, 16)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    ct = rng.normal(size=(2, 16 // stride, 32 // stride, cout)
                    ).astype(np.float32)

    def loss(m, xx):
        y = m(xx)
        return jnp.sum(y.astype(jnp.float32) * ct), y

    (_, want_y), (gm, gx) = nnx.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(j, xj)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    xt.requires_grad_(True)
    y = t(xt)
    (y.float() * torch.from_numpy(ct)).sum().backward()
    assert j_calls == [stride] and t_calls == [stride]

    want_y = np.asarray(want_y, np.float32)
    assert y.dtype == torch.bfloat16
    assert _rel(y.detach().float().numpy(), want_y) < 2e-2
    assert _rel(xt.grad.float().numpy(), np.asarray(gx, np.float32)) < 2e-2
    c = nnx.clone(j)
    nnx.update(c, gm)
    got = dict(t.named_parameters())
    for key, r in export_torch_state_dict(c).items():
        if key.endswith(("running_mean", "running_var")):
            continue
        # the expand BN scale's gradient is the difference of its paths
        # through W′ and through b′, which the dw BN nearly cancels: bf16
        # noise weighs twice as much there
        bar = 4e-2 if key == "expand.bn.weight" else 2e-2
        assert _rel(got[key].grad.float().numpy(), r) < bar, key
    np.testing.assert_allclose(t.dw.bn.running_mean.numpy(),
                               np.asarray(j.dw.bn.mean[...], np.float32),
                               rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(t.expand.bn.running_var.numpy(),
                               np.asarray(j.expand.bn.var[...], np.float32),
                               rtol=1e-4, atol=1e-6)
