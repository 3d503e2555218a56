"""PyTorch port, DeepLabV3 and its blocks on the CPU against the JAX
package, in float32, the JAX weights carried by `export_torch_state_dict`
→ `state_dict_from_jax` and loaded with strict=True:

- a dilated BasicBlock and a dilated, strided BottleneckBlock, eval mode,
  at 1e-5 of scale;
- ASPP in eval and in train mode (its image-level branch normalises over
  the N values of each channel), at 1e-5 of scale;
- `deeplabv3_resnet18` at 4x64x64: eval logits at 1e-4, and 3 SGD steps
  with `upsample_logits=False` and `resize_ohem_cross_entropy` (dropout
  rate 0 on both sides: the two frameworks draw different masks) at
  rtol = atol = 1e-4, the bar of tests/test_torch_train.py; both sides
  compute in float32 and differ in summation order. A batch of 4, as in
  that test: ASPP's image-level BN normalises over N values a channel,
  and over 2 its E[x²]−E[x]² amplifies float32 noise past the bar (a
  running mean 1.6e-4 apart after 3 steps). ResNet-50 runs only on the
  card (`chip_smoke.py`), to keep the JAX package's CPU compile out of
  these tests."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu.losses import (
    resize_ohem_cross_entropy as j_resize_ohem)
from torch_semantic_segmentation_tpu.models import deeplab as jdeeplab
from torch_semantic_segmentation_tpu.models import resnet as jresnet
from torch_semantic_segmentation_tpu.ops.blocks import ASPP as JASPP
from torch_semantic_segmentation_tpu_torch.losses import (
    resize_ohem_cross_entropy)
from torch_semantic_segmentation_tpu_torch.models import (
    available_models, deeplab, get_model, resnet)
from torch_semantic_segmentation_tpu_torch.ops import ASPP

from torch_port_util import carry_weights, sgd_steps_match_jax

torch.set_num_threads(2)

N, H, W, C = 4, 64, 64, 5
LR = 0.002   # as tests/test_torch_train.py
OHEM = dict(thresh=0.7, min_kept=2000)


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("kind,cin,ch,stride,dilation", [
    ("BasicBlock", 8, 8, 1, 2), ("BasicBlock", 8, 12, 2, 1),
    ("BottleneckBlock", 16, 4, 1, 4), ("BottleneckBlock", 8, 4, 2, 2)])
def test_resnet_blocks_match_jax(kind, cin, ch, stride, dilation):
    j = getattr(jresnet, kind)(cin, ch, stride=stride, dilation=dilation,
                               rngs=nnx.Rngs(0))
    t = getattr(resnet, kind)(cin, ch, stride=stride, dilation=dilation)
    carry_weights(j, t, seed=1)
    x = np.random.default_rng(2).normal(size=(2, 12, 14, cin)).astype(
        np.float32)
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(j(jnp.asarray(x))), 1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_aspp_matches_jax(train):
    j = JASPP(16, 8, rates=(1, 2, 3), rngs=nnx.Rngs(0))
    t = ASPP(16, 8, rates=(1, 2, 3))
    carry_weights(j, t, seed=3)
    if train:
        j.train()
        t.train()
    x = np.random.default_rng(4).normal(size=(4, 6, 7, 16)).astype(np.float32)
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(j(jnp.asarray(x))), 1e-5)


def _models(upsample_logits=True):
    j = jdeeplab.deeplabv3_resnet18(C, upsample_logits=upsample_logits,
                                    rngs=nnx.Rngs(0))
    j.dropout.rate = 0.0
    t = deeplab.deeplabv3_resnet18(C, upsample_logits=upsample_logits,
                                   device="cpu")
    t.dropout.rate = 0.0
    return j, t


def _batches(steps):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(steps):
        x = rng.normal(size=(N, H, W, 3)).astype(np.float32)
        y = rng.integers(0, C, (N, H, W)).astype(np.int32)
        y[:, :4, :9] = 255
        out.append((x, y))
    return out


def test_deeplab_eval_logits_match_jax():
    j, t = _models()
    carry_weights(j, t, seed=6)
    x = _batches(1)[0][0]
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    assert got.shape == (N, H, W, C)
    _close(got, np.asarray(j(jnp.asarray(x))), 1e-4)


def test_deeplab_ohem_sgd_steps_match_jax():
    j, t = _models(upsample_logits=False)
    sgd_steps_match_jax(
        j, t, functools.partial(j_resize_ohem, **OHEM),
        functools.partial(resize_ohem_cross_entropy, **OHEM), _batches(3),
        lr=LR)


def test_registry_output_strides_and_aux():
    assert {"unet", "deeplabv3_resnet18", "deeplabv3_resnet34",
            "deeplabv3_resnet50", "deeplabv3_resnet101"} <= set(
                available_models())
    x = torch.zeros(1, 64, 64, 3)
    for os_, side in ((8, 8), (16, 4), (32, 2)):
        m = get_model("deeplabv3_resnet18", C, output_stride=os_,
                      upsample_logits=False, device="cpu").eval()
        with torch.no_grad():
            assert tuple(m(x).shape) == (1, side, side, C)
    m = get_model("deeplabv3_resnet18", C, aux=True, device="cpu").eval()
    with torch.no_grad():
        main, aux = m(x)
    assert tuple(main.shape) == (1, 64, 64, C) and aux.shape[-1] == C
    r50 = resnet.ResNet(50)
    assert r50.out_channels == 2048 and r50.c3_channels == 1024
    # the multi-grid dilations of the final stage at output stride 16
    assert [b.conv2.conv.dilation for b in r50.stage4] == [(2, 2), (4, 4),
                                                          (8, 8)]
    with pytest.raises(ValueError, match="output_stride"):
        resnet.ResNet(18, output_stride=4)
