"""PyTorch port, ICNet (BASELINE config 5) and K3 at ICNet's ratios on the
CPU against the JAX package, in float32, the JAX weights carried by
`export_torch_state_dict` → `state_dict_from_jax` and loaded with
strict=True:

- K3's plain map and its backward against the JAX package's Pallas
  `per_pixel_resize_ce` in interpret mode at x4 (ICNet's main head) and
  x8, at `tests/test_torch_ohem.py`'s bars (the map at rtol = atol = 1e-5,
  d(logits) within two bf16 steps of its largest element);
- the cascade feature fusion in train mode at 1e-5 of scale;
- ICNet-R18 at 4x64x64: the main head's (full-resolution) and the aux
  heads' (1/8, 1/16) eval logits at 1e-4 of scale; 3 SGD steps with
  `aux_weighted_loss` (aux weight 1.0) and OHEM on both routes, the main
  head at full resolution with `ohem_cross_entropy` (the aux heads
  resized first) and at 1/4 with `resize_ohem_cross_entropy`, at
  rtol = atol = 1e-4. A batch of 4: the pyramid pooling's 1-bin BN
  normalises over N values a channel;
- one `remat=True` step bit for bit against the step without it.
ResNet-18 here; config 5's ICNet-R50 runs on the card (`chip_smoke.py`)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu.models.icnet import (
    CascadeFeatureFusion as JCFF, icnet as j_icnet)
from torch_semantic_segmentation_tpu.ops import pallas_resize_ce as prce
from torch_semantic_segmentation_tpu_torch.models import get_model
from torch_semantic_segmentation_tpu_torch.models.icnet import (
    CascadeFeatureFusion)
from torch_semantic_segmentation_tpu_torch.ops import resize_ce

from torch_port_util import (
    aux_ohem_losses, carry_weights, remat_step_is_bit_exact,
    sgd_steps_match_jax)

torch.set_num_threads(2)

N, H, W, C = 4, 64, 64, 5
OHEM = dict(thresh=0.7, min_kept=2000)
D_TOL = 2.0 ** -7   # of max|d(logits)|: two bf16 steps at the top


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _labels(rng, n, h, w, c=C):
    y = rng.integers(0, c, (n, h, w)).astype(np.int32)
    y[:, :4, :9] = 255
    return y


@pytest.mark.parametrize("lshape,yshape", [
    ((1, 8, 32, 19), (32, 128)), ((2, 16, 64, 19), (64, 256)),
    ((1, 4, 16, 19), (32, 128))], ids=["x4", "x4-two-images", "x8"])
def test_map_plain_version_matches_jax_kernel_at_x4_and_x8(lshape, yshape):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=lshape) * 2).astype(np.float32)
    labels = _labels(rng, lshape[0], *yshape, c=lshape[-1])
    ct = rng.normal(size=(lshape[0], *yshape)).astype(np.float32)
    fn = functools.partial(prce.per_pixel_resize_ce,
                           labels=jnp.asarray(labels), interpret=True)
    want_map, vjp = jax.vjp(fn, jnp.asarray(logits, jnp.bfloat16))
    want_dx = np.asarray(vjp(jnp.asarray(ct))[0], np.float32)
    lt = torch.from_numpy(logits).to(torch.bfloat16)
    lab = torch.from_numpy(labels)
    got_map, logz = resize_ce.resize_ce_map_forward(lt, lab)
    np.testing.assert_allclose(got_map.numpy(), np.asarray(want_map),
                               rtol=1e-5, atol=1e-5)
    dx = resize_ce.resize_ce_map_backward(lt, lab, logz, torch.from_numpy(ct))
    np.testing.assert_allclose(dx.float().numpy(), want_dx, rtol=0,
                               atol=D_TOL * np.abs(want_dx).max())


def test_cff_matches_jax_in_train_mode():
    j, t = JCFF(6, 5, 8, rngs=nnx.Rngs(0)), CascadeFeatureFusion(6, 5, 8)
    carry_weights(j, t, seed=1)
    j.train()
    t.train()
    rng = np.random.default_rng(2)
    low = rng.normal(size=(4, 4, 5, 6)).astype(np.float32)
    high = rng.normal(size=(4, 8, 10, 5)).astype(np.float32)
    with torch.no_grad():
        got = t(torch.from_numpy(low), torch.from_numpy(high))
    want = j(jnp.asarray(low), jnp.asarray(high))
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), 1e-5)


def _models(upsample_logits=True):
    return (j_icnet(C, depth=18, upsample_logits=upsample_logits,
                    rngs=nnx.Rngs(0)),
            get_model("icnet", C, depth=18, upsample_logits=upsample_logits,
                      device="cpu"))


def _batches(steps, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(N, H, W, 3)).astype(np.float32),
             _labels(rng, N, H, W)) for _ in range(steps)]


def test_icnet_eval_logits_match_jax():
    j, t = _models()
    carry_weights(j, t, seed=4)
    x = _batches(1)[0][0]
    with torch.no_grad():
        got = t(torch.from_numpy(x))
    want = j(jnp.asarray(x))
    assert [tuple(g.shape) for g in got] == [(N, H, W, C), (N, 8, 8, C),
                                             (N, 4, 4, C)]
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), 1e-4)
    _, low = _models(upsample_logits=False)
    with torch.no_grad():
        main = low.eval()(torch.from_numpy(x))[0]
    assert tuple(main.shape) == (N, H // 4, W // 4, C)


@pytest.mark.parametrize("upsample_logits", [True, False])
def test_icnet_aux_ohem_sgd_steps_match_jax(upsample_logits):
    j, t = _models(upsample_logits)
    jloss, tloss = aux_ohem_losses(not upsample_logits, **OHEM)
    sgd_steps_match_jax(j, t, jloss, tloss, _batches(3))


def test_icnet_remat_step_equals_the_step_without_remat():
    x, y = (torch.from_numpy(a) for a in _batches(1, seed=5)[0])
    remat_step_is_bit_exact(
        lambda: get_model("icnet", C, depth=18, upsample_logits=False,
                          device="cpu"),
        aux_ohem_losses(True, **OHEM)[1], x, y)
