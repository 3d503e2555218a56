"""PyTorch port, UNet and its new ops on the CPU against the JAX package:
`ConvTranspose2d` and `max_pool2d` forward and gradient at 1e-5; UNet with
base_ch 4 at 2x32x64 in float32, for the deconv decoder, the bilinear one
(through K4's plain version) and the bilinear one with align_corners=True,
eval logits at 1e-4 and 3 SGD steps at rtol = atol = 1e-4 (the bar of
tests/test_torch_train.py; both sides compute in float32 and differ in
summation order). The JAX weights are carried by `export_torch_state_dict`
→ `state_dict_from_jax` and loaded with strict=True. The JAX package's
train-mode deconv UNet would route its packed W-layout rim
(`ops/packed_unet.py`) where `TPU_SEG_PACKED_UNET_BODY` says so; the tests
set it to 0, and the port has no such rim."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu import train as jtrain
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.losses import (
    cross_entropy_loss as j_ce_loss)
from torch_semantic_segmentation_tpu.models.unet import unet as j_unet
from torch_semantic_segmentation_tpu.ops.conv import (
    ConvTranspose2d as JConvTranspose2d)
from torch_semantic_segmentation_tpu.ops.pool import max_pool2d as j_max_pool
from torch_semantic_segmentation_tpu_torch import train as ttrain
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax
from torch_semantic_segmentation_tpu_torch.losses import cross_entropy_loss
from torch_semantic_segmentation_tpu_torch.models import get_model, unet
from torch_semantic_segmentation_tpu_torch.ops import (
    ConvTranspose2d, max_pool2d, upsample_concat)

from torch_port_util import carry_weights

torch.set_num_threads(2)

N, H, W, C, BASE = 2, 32, 64, 5, 4
LR = 0.002   # as tests/test_torch_train.py: train-mode BN at init amplifies
#              float32 noise at larger rates
VARIANTS = [("deconv", False), ("bilinear", False), ("bilinear", True)]


@pytest.fixture(autouse=True)
def _no_packed_rim(monkeypatch):
    monkeypatch.setenv("TPU_SEG_PACKED_UNET_BODY", "0")


@pytest.mark.parametrize("k,s,p,op", [(2, 2, 0, 0), (3, 2, 1, 1),
                                      (3, 1, 1, 0)])
def test_conv_transpose_matches_jax(k, s, p, op):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    jm = JConvTranspose2d(6, 4, k, stride=s, padding=p, output_padding=op,
                          rngs=nnx.Rngs(0))
    tm = ConvTranspose2d(6, 4, k, stride=s, padding=p, output_padding=op)
    tm.load_state_dict(state_dict_from_jax(export_torch_state_dict(jm)),
                       strict=True)
    assert tuple(tm.weight.shape) == (6, 4, k, k)      # torch's (in, out, kh, kw)
    y = jm(jnp.asarray(x))
    g = rng.normal(size=y.shape).astype(np.float32)
    jgx = nnx.grad(lambda m, a: jnp.sum(m(a) * g), argnums=1)(jm, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tm(xt)
    (yt * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window,stride,padding", [(2, 2, 0), (3, 2, 1),
                                                   (3, 1, 1)])
def test_max_pool_matches_jax_with_ties(window, stride, padding):
    """Values rounded to integers, so many windows hold a tied maximum:
    both packages give its gradient to the first maximum in row-major
    order (and the −inf padding never wins)."""
    rng = np.random.default_rng(1)
    x = np.round(rng.normal(size=(2, 9, 10, 3))).astype(np.float32)
    y = j_max_pool(jnp.asarray(x), window, stride, padding)
    g = rng.normal(size=y.shape).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(j_max_pool(a, window, stride, padding)
                                    * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = max_pool2d(xt, window, stride, padding)
    (yt * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)


def _models(upsample, align_corners):
    j = j_unet(C, base_ch=BASE, upsample=upsample, rngs=nnx.Rngs(0))
    for blk in (j.up4, j.up3, j.up2, j.up1):
        blk.align_corners = align_corners
    t = unet(C, base_ch=BASE, upsample=upsample, align_corners=align_corners,
             device="cpu")
    return j, t


def _batches(steps):
    rng = np.random.default_rng(2)
    out = []
    for _ in range(steps):
        x = rng.normal(size=(N, H, W, 3)).astype(np.float32)
        y = rng.integers(0, C, (N, H, W)).astype(np.int32)
        y[:, :3, :7] = 255
        out.append((x, y))
    return out


@pytest.mark.parametrize("upsample,align_corners", VARIANTS)
def test_unet_eval_logits_match_jax(upsample, align_corners):
    j, t = _models(upsample, align_corners)
    carry_weights(j, t, seed=3)
    x = _batches(1)[0][0]
    before = upsample_concat.upsample_concat_forward.launches
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    assert upsample_concat.upsample_concat_forward.launches == before
    want = np.asarray(j(jnp.asarray(x)))
    assert got.shape == (N, H, W, C)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("upsample,align_corners", VARIANTS)
def test_unet_sgd_steps_match_jax(upsample, align_corners):
    j, t = _models(upsample, align_corners)
    t.load_state_dict(state_dict_from_jax(export_torch_state_dict(j)),
                      strict=True)
    tx = jtrain.OptimizerConfig(lr=LR, max_steps=4).make()
    gd, _, jstate = jtrain.create_train_state(j, tx)
    jstep = jtrain.make_train_step(gd, tx, j_ce_loss)
    tstate = ttrain.create_train_state(t, ttrain.OptimizerConfig(
        lr=LR, max_steps=4))
    tstep = ttrain.make_train_step(t, tstate, cross_entropy_loss,
                                   device="cpu")
    for i, (x, y) in enumerate(_batches(3), start=1):
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tm = tstep(x, y)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"loss at step {i}")
    want = state_dict_from_jax(export_torch_state_dict(
        nnx.merge(gd, jstate.params, jstate.rest)))
    got = t.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)


def test_camvid_crop_is_refused_by_both_packages():
    """BASELINE config 3 crops CamVid at 360x480 (configs/unet_camvid.json),
    but UNet needs H and W divisible by 16 and 360 % 16 == 8: both
    packages refuse it."""
    j, t = _models("deconv", False)
    x = np.zeros((1, 360, 480, 3), np.float32)
    with pytest.raises(ValueError, match="divisible by 16"):
        j(jnp.asarray(x))
    with pytest.raises(ValueError, match="divisible by 16"):
        t(torch.from_numpy(x))


def test_registry_and_state_dict_keys():
    j, t = _models("bilinear", False)
    assert set(t.state_dict()) == set(state_dict_from_jax(
        export_torch_state_dict(j)))
    m = get_model("unet", C, base_ch=BASE, upsample="bilinear", device="cpu")
    assert isinstance(m.up1.up, torch.nn.Conv2d)
    with pytest.raises(ValueError, match="upsample"):
        unet(C, base_ch=BASE, upsample="nearest", device="cpu")
