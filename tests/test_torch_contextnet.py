"""PyTorch port, ContextNet on the CPU against the JAX package, the JAX
weights carried by `export_torch_state_dict` → `state_dict_from_jax` and
loaded with strict=True, the JAX package on its plain path
(`TPU_SEG_PACKED_CONTEXTNET=0`):

- ContextNet at 2x64x96 with its aux heads, on both `upsample_logits`
  routes: the three heads' eval logits at 1e-4 of scale; 3 SGD steps
  through `aux_weighted_loss` (aux weight 0.4; plain CE, whose low-res aux
  heads are resized first, or the resize CE, which takes each head at its
  own resolution), dropout at rate 0 on both sides, against the JAX
  package's steps in float64 (`jax_enable_x64`, the float32 draw cast):
  every loss at rtol 1e-4, every parameter and BN statistic at rtol =
  atol = 1e-4 on the full-resolution route and 2e-4 on the 1/8 one: after
  3 steps the port's float32 run lies 0.079 and 1.11 times the 1e-4 bar
  from JAX's float64 run (the 1/8 route's worst is
  `context.body.0.expand.conv.weight`, its next 0.75), and the JAX
  package's own float32 run 29.2 and 29.5 times (`python
  scripts/port_sgd_gap.py contextnet --width 96 --aux [--low-res]`), so
  its float32 steps cannot serve as the reference; one `remat=True` step
  bit for bit against the step without it; the "divisible by 32"
  ValueError raised by both packages.

K2's and K6's plain versions against the JAX package's kernels at
ContextNet's new shapes: tests/test_torch_contextnet_kernels.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu import losses as jlosses
from torch_semantic_segmentation_tpu.models.contextnet import (
    contextnet as j_contextnet)
from torch_semantic_segmentation_tpu_torch import losses as tlosses
from torch_semantic_segmentation_tpu_torch.models import get_model
from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout

from torch_port_util import (
    carry_weights, jax_model_at, jax_x64, remat_step_is_bit_exact,
    sgd_steps_match_jax)

torch.set_num_threads(2)

N, H, W, C = 2, 64, 96, 5
# every parameter and BN statistic after 3 steps against JAX's float64
# steps, rtol = atol, by upsample_logits (measured)
STATE_TOL = {True: 1e-4, False: 2e-4}


@pytest.fixture(autouse=True)
def _plain_jax_path(monkeypatch):
    monkeypatch.setenv("TPU_SEG_PACKED_CONTEXTNET", "0")


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _jax_model(upsample_logits):
    """JAX ContextNet with aux heads, dropout at rate 0."""
    j = j_contextnet(C, aux=True, upsample_logits=upsample_logits,
                     rngs=nnx.Rngs(0))
    for _, m in nnx.iter_graph(j):
        if isinstance(m, nnx.Dropout):
            m.rate = 0.0
    return j


def _port_model(upsample_logits, rate=None):
    t = get_model("contextnet", C, aux=True, upsample_logits=upsample_logits,
                  device="cpu")
    if rate is not None:
        for m in t.modules():
            if isinstance(m, Dropout):
                m.rate = rate
    return t


def _losses(upsample_logits):
    """(JAX loss, port loss): main + 0.4 · aux over the three heads."""
    name = ("cross_entropy_loss" if upsample_logits
            else "resize_cross_entropy_loss")
    return (functools.partial(jlosses.aux_weighted_loss,
                              loss_fn=getattr(jlosses, name), aux_weight=0.4),
            functools.partial(tlosses.aux_weighted_loss,
                              loss_fn=getattr(tlosses, name), aux_weight=0.4))


def _batches(steps, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        x = rng.normal(size=(N, H, W, 3)).astype(np.float32)
        y = rng.integers(0, C, (N, H, W)).astype(np.int32)
        y[:, :4, :9] = 255
        out.append((x, y))
    return out


@pytest.mark.parametrize("upsample_logits", [True, False])
def test_eval_logits_match_jax(upsample_logits):
    j, t = _jax_model(upsample_logits), _port_model(upsample_logits)
    carry_weights(j, t, seed=4)
    x = _batches(1)[0][0]
    with torch.no_grad():
        got = t(torch.from_numpy(x))
    want = j(jnp.asarray(x))
    main = (H, W) if upsample_logits else (H // 8, W // 8)
    assert [tuple(g.shape) for g in got] == [
        (N, *main, C), (N, H // 8, W // 8, C), (N, H // 32, W // 32, C)]
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), 1e-4)


@pytest.mark.parametrize("upsample_logits", [True, False])
def test_aux_sgd_steps_match_jax_float64(upsample_logits):
    j, t = _jax_model(upsample_logits), _port_model(upsample_logits, rate=0.0)
    with jax_x64():
        sgd_steps_match_jax(jax_model_at(j, jnp.float64), t,
                            *_losses(upsample_logits), _batches(3),
                            state_tol=STATE_TOL[upsample_logits])


def test_remat_step_equals_the_step_without_remat():
    x, y = (torch.from_numpy(a) for a in _batches(1, seed=5)[0])
    assert {m.rate for m in _port_model(False).modules()
            if isinstance(m, Dropout)} == {0.1}
    remat_step_is_bit_exact(lambda: _port_model(False), _losses(False)[1],
                            x, y)


def test_both_packages_refuse_sizes_off_32():
    j, t = _jax_model(True), _port_model(True)
    x = np.zeros((1, 64, 80, 3), np.float32)
    with pytest.raises(ValueError, match="divisible by 32"):
        j(jnp.asarray(x))
    with pytest.raises(ValueError, match="divisible by 32"):
        t(torch.from_numpy(x))
