"""PyTorch port, the rematerialised training step (`make_train_step(...,
remat=True)`) of the models beside FastSCNN, on the CPU:

- the remat segments of UNet (both decoders) and DeepLabV3 (with and
  without its aux head) hold every parameter of the model once;
- against the port's own step without remat, float32, one SGD step:
  UNet (base 4, bilinear decoder through K4's plain version, 2x32x64),
  DeepLabV3-R18 at 4x64x64 (a batch of 4 for ASPP's image-level BN, as in
  `test_torch_deeplab.py`) with its aux head and its dropout 0.1 drawn
  from the model's generator, and a model with no `remat_segments`, which
  is checkpointed whole: loss, every gradient, every parameter, every BN
  running statistic and the generator's state are equal bit for bit;
- UNet's remat step against the JAX package's `make_train_step(remat=
  True)`, 2 SGD steps at `test_torch_unet.py`'s bars (losses rtol 1e-4,
  the state at rtol = atol = 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from torch import nn

from torch_semantic_segmentation_tpu import train as jtrain
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.losses import (
    cross_entropy_loss as j_ce_loss)
from torch_semantic_segmentation_tpu.models.unet import unet as j_unet
from torch_semantic_segmentation_tpu_torch import train as ttrain
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax
from torch_semantic_segmentation_tpu_torch.losses import (
    cross_entropy_loss, resize_cross_entropy_loss)
from torch_semantic_segmentation_tpu_torch.models import deeplab, unet

torch.set_num_threads(2)

C = 5
LR = 0.002   # as tests/test_torch_unet.py


class _Whole(nn.Module):
    """A model with no `remat_segments`: the remat step checkpoints its
    whole forward."""

    def __init__(self):
        super().__init__()
        self.inner = unet(C, base_ch=4, upsample="deconv", device="cpu")

    def forward(self, x):
        return self.inner(x)


def _deeplab_loss(outputs, labels):
    main, aux = outputs
    return (resize_cross_entropy_loss(main, labels)
            + 0.4 * resize_cross_entropy_loss(aux, labels))


def _case(name):
    """(model, loss_fn, batch shape) of a named case, float32."""
    if name == "unet":
        return (unet(C, base_ch=4, upsample="bilinear", device="cpu"),
                cross_entropy_loss, (2, 32, 64))
    if name == "whole":
        return _Whole(), cross_entropy_loss, (2, 32, 64)
    m = deeplab.deeplabv3_resnet18(C, aux=True, upsample_logits=False,
                                   device="cpu")
    assert m.dropout.rate == 0.1 and m.aux_head.dropout.rate == 0.1
    return m, _deeplab_loss, (4, 64, 64)


def _port_step(name: str, remat: bool):
    """One SGD step from the seed; returns (loss, gradients, state dict,
    the dropout generator's state or None)."""
    model, loss_fn, (n, h, w) = _case(name)
    state = ttrain.create_train_state(model, ttrain.OptimizerConfig(lr=0.01))
    step = ttrain.make_train_step(model, state, loss_fn, remat=remat,
                                  device="cpu")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(n, h, w, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, C, (n, h, w)))
    y[:, :3, :5] = 255
    loss = step(x, y)["loss"]
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    gen = getattr(model, "dropout_generator", None)
    return (float(loss), grads,
            {k: v.clone() for k, v in model.state_dict().items()},
            None if gen is None else gen.get_state())


@pytest.mark.parametrize("name,kw", [
    ("unet", dict(upsample="deconv")), ("unet", dict(upsample="bilinear")),
    ("deeplab", dict(aux=False)), ("deeplab", dict(aux=True))])
def test_zoo_remat_segments_hold_every_parameter_once(name, kw):
    model = (unet(C, base_ch=4, device="cpu", **kw) if name == "unet"
             else deeplab.deeplabv3_resnet18(C, device="cpu", **kw))
    held = [id(p) for seg in model.remat_segments() for p in seg.parameters()]
    assert len(held) == len(set(held))
    assert set(held) == {id(p) for p in model.parameters()}


@pytest.mark.parametrize("name", ["unet", "deeplab", "whole"])
def test_zoo_remat_step_equals_the_step_without_remat(name):
    loss0, grads0, state0, gen0 = _port_step(name, remat=False)
    loss1, grads1, state1, gen1 = _port_step(name, remat=True)
    assert loss0 == loss1
    assert set(grads0) == set(grads1) and set(state0) == set(state1)
    for k in grads0:
        torch.testing.assert_close(grads1[k], grads0[k], rtol=0, atol=0,
                                   msg=f"gradient {k}")
    for k in state0:
        torch.testing.assert_close(state1[k], state0[k], rtol=0, atol=0,
                                   msg=k)
    if gen0 is not None:
        assert torch.equal(gen0, gen1)


def test_unet_remat_step_matches_jax(monkeypatch):
    monkeypatch.setenv("TPU_SEG_PACKED_UNET_BODY", "0")
    j = j_unet(C, base_ch=4, upsample="bilinear", rngs=nnx.Rngs(0))
    t = unet(C, base_ch=4, upsample="bilinear", device="cpu")
    t.load_state_dict(state_dict_from_jax(export_torch_state_dict(j)),
                      strict=True)
    tx = jtrain.OptimizerConfig(lr=LR, max_steps=4).make()
    gd, _, jstate = jtrain.create_train_state(j, tx)
    jstep = jtrain.make_train_step(gd, tx, j_ce_loss, remat=True)
    tstate = ttrain.create_train_state(t, ttrain.OptimizerConfig(
        lr=LR, max_steps=4))
    tstep = ttrain.make_train_step(t, tstate, cross_entropy_loss, remat=True,
                                   device="cpu")
    rng = np.random.default_rng(2)
    for i in range(1, 3):
        x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
        y = rng.integers(0, C, (2, 32, 64)).astype(np.int32)
        y[:, :3, :7] = 255
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
