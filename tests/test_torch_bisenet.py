"""PyTorch port, BiSeNet (BASELINE config 5) and the aux-head loss on the
CPU against the JAX package, in float32, the JAX weights carried by
`export_torch_state_dict` → `state_dict_from_jax` and loaded with
strict=True:

- `aux_weighted_loss` over heads at three resolutions, with a loss that
  resizes inside (`handles_resize`: `resize_ohem_cross_entropy`, a
  `SegLoss` built with it) and with one that does not (the heads resized
  first): value and gradients at 1e-5;
- the attention refinement and feature fusion modules in train mode at
  1e-5 of scale;
- BiSeNet-R18 at 4x64x64: the three heads' eval logits at 1e-4 of scale;
  3 SGD steps with `aux_weighted_loss` (aux weight 1.0) and OHEM on both
  routes, full-resolution heads with `ohem_cross_entropy` and low-res
  heads with `resize_ohem_cross_entropy`, at rtol = atol = 1e-4. A batch
  of 4: the ARM gates' and the context tail's BN normalise over N values
  a channel, as ASPP's image-level BN does in tests/test_torch_deeplab.py;
- one `remat=True` step bit for bit against the step without it.
ResNet-18 here; config 5's BiSeNet runs on the card (`chip_smoke.py`)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu import losses as jlosses
from torch_semantic_segmentation_tpu.models.bisenet import (
    AttentionRefinement as JARM, FeatureFusionModule as JFFM,
    bisenet as j_bisenet)
from torch_semantic_segmentation_tpu_torch import losses as tlosses
from torch_semantic_segmentation_tpu_torch.models import get_model
from torch_semantic_segmentation_tpu_torch.models.bisenet import (
    AttentionRefinement, FeatureFusionModule)

from torch_port_util import (
    aux_ohem_losses, carry_weights, remat_step_is_bit_exact,
    sgd_steps_match_jax)

torch.set_num_threads(2)

N, H, W, C = 4, 64, 64, 5
OHEM = dict(thresh=0.7, min_kept=2000)


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _labels(rng, n, h, w):
    y = rng.integers(0, C, (n, h, w)).astype(np.int32)
    y[:, :4, :9] = 255
    return y


@pytest.mark.parametrize("case", ["resize_ohem", "segloss", "plain_ce"])
def test_aux_weighted_loss_matches_jax(case):
    rng = np.random.default_rng(0)
    heads = [rng.normal(size=(2, s, s, C)).astype(np.float32) * 2
             for s in (32, 8, 4)]
    y = _labels(rng, 2, 32, 32)
    if case == "resize_ohem":
        jfn, tfn = (jlosses.resize_ohem_cross_entropy,
                    tlosses.resize_ohem_cross_entropy)
        assert tfn.handles_resize
        assert tlosses.resize_cross_entropy_loss.handles_resize
        kw = OHEM
    elif case == "segloss":
        jfn = jlosses.SegLoss(functools.partial(
            jlosses.resize_ohem_cross_entropy, **OHEM), handles_resize=True)
        tfn = tlosses.SegLoss(functools.partial(
            tlosses.resize_ohem_cross_entropy, **OHEM), handles_resize=True)
        kw = {}
    else:
        jfn, tfn = jlosses.cross_entropy_loss, tlosses.cross_entropy_loss
        assert not getattr(tfn, "handles_resize", False)
        kw = {}
    wv, wg = jax.value_and_grad(lambda hs: jlosses.aux_weighted_loss(
        hs, jnp.asarray(y), loss_fn=jfn, aux_weight=0.4, **kw))(
        [jnp.asarray(h) for h in heads])
    ts = [torch.from_numpy(h).requires_grad_(True) for h in heads]
    val = tlosses.aux_weighted_loss(ts, torch.from_numpy(y), loss_fn=tfn,
                                    aux_weight=0.4, **kw)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(wv), rtol=1e-5)
    for t, g in zip(ts, wg):
        _close(t.grad.numpy(), np.asarray(g), 1e-5)


@pytest.mark.parametrize("name", ["arm", "ffm"])
def test_arm_and_ffm_match_jax_in_train_mode(name):
    if name == "arm":
        j, t = JARM(8, 6, rngs=nnx.Rngs(0)), AttentionRefinement(8, 6)
        args = [np.random.default_rng(1).normal(size=(4, 6, 7, 8))]
    else:
        j, t = JFFM(12, 8, rngs=nnx.Rngs(0)), FeatureFusionModule(12, 8)
        rng = np.random.default_rng(2)
        args = [rng.normal(size=(4, 6, 7, 5)), rng.normal(size=(4, 6, 7, 7))]
    carry_weights(j, t, seed=3)
    j.train()
    t.train()
    args = [a.astype(np.float32) for a in args]
    with torch.no_grad():
        got = t(*(torch.from_numpy(a) for a in args)).numpy()
    _close(got, np.asarray(j(*(jnp.asarray(a) for a in args))), 1e-5)


def _models(upsample_logits=True):
    return (j_bisenet(C, depth=18, upsample_logits=upsample_logits,
                      rngs=nnx.Rngs(0)),
            get_model("bisenet", C, depth=18,
                      upsample_logits=upsample_logits, device="cpu"))


def _batches(steps, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(N, H, W, 3)).astype(np.float32),
             _labels(rng, N, H, W)) for _ in range(steps)]


def test_bisenet_eval_logits_match_jax():
    j, t = _models()
    carry_weights(j, t, seed=5)
    x = _batches(1)[0][0]
    with torch.no_grad():
        got = t(torch.from_numpy(x))
    want = j(jnp.asarray(x))
    assert isinstance(got, tuple) and len(got) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == (N, H, W, C)
        _close(g.numpy(), np.asarray(w), 1e-4)
    _, low = _models(upsample_logits=False)
    with torch.no_grad():
        shapes = [tuple(o.shape) for o in low.eval()(torch.from_numpy(x))]
    assert shapes == [(N, 8, 8, C), (N, 8, 8, C), (N, 4, 4, C)]


@pytest.mark.parametrize("upsample_logits", [True, False])
def test_bisenet_aux_ohem_sgd_steps_match_jax(upsample_logits):
    j, t = _models(upsample_logits)
    jloss, tloss = aux_ohem_losses(not upsample_logits, **OHEM)
    sgd_steps_match_jax(j, t, jloss, tloss, _batches(3))


def test_bisenet_remat_step_equals_the_step_without_remat():
    x, y = (torch.from_numpy(a[:2]) for a in _batches(1, seed=6)[0])
    remat_step_is_bit_exact(
        lambda: get_model("bisenet", C, depth=18, upsample_logits=False,
                          device="cpu"),
        aux_ohem_losses(True, **OHEM)[1], x, y)
