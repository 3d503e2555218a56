"""PyTorch port, the rematerialised training step (`make_train_step(...,
remat=True)`) on the CPU:

- FastSCNN's remat segments (`remat_segments`, each checkpointed on its
  own) hold every parameter of the model once;
- against the port's own step without remat and with K2 suppressed (what
  the remat step runs inside its checkpoints), FastSCNN bf16 at 2x64x128
  with dropout 0.1 drawn from the model's generator and K6 routed (its
  pixel floor at 0): loss, every parameter, every BN running statistic and
  the generator's state are equal after a step. This fails if the
  recompute moves the running statistics a second time or draws a new
  dropout mask (checkpoint restores torch's global RNG, not the model's
  generator);
- against the JAX package's `make_train_step(remat=True)` in float32 with
  dropout 0, at `test_torch_train.py`'s bars.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu import train as jtrain
from torch_semantic_segmentation_tpu.losses import (
    resize_cross_entropy_loss as j_resize_ce_loss)
from torch_semantic_segmentation_tpu_torch import train as ttrain
from torch_semantic_segmentation_tpu_torch.losses import (
    resize_cross_entropy_loss)
from torch_semantic_segmentation_tpu_torch.models import fastscnn
from torch_semantic_segmentation_tpu_torch.ops import conv as tconv
from torch_semantic_segmentation_tpu_torch.ops import depthwise, mbconv

from tests.test_torch_train import (
    LR, _assert_same_state, _batches, _jax_state_dict, _models)

torch.set_num_threads(2)


def _spy_wrappers(monkeypatch) -> dict:
    """Count the calls of the K2 and K6 wrappers in the returned dict."""
    calls = {}
    for mod, name in ((mbconv, "expand_dw_forward"),
                      (depthwise, "depthwise3x3_forward"),
                      (depthwise, "depthwise3x3_backward")):
        def spy(*args, _real=getattr(mod, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args)
        monkeypatch.setattr(mod, name, spy)
    return calls


def _port_step(remat: bool):
    """One bf16 step from the seed; returns (loss, state dict, the dropout
    generator's state)."""
    model = fastscnn(19, upsample_logits=False, compute_dtype=torch.bfloat16,
                     seed=0, device="cpu")
    assert model.classifier.dropout.rate == 0.1
    state = ttrain.create_train_state(model, ttrain.OptimizerConfig(lr=0.045))
    step = ttrain.make_train_step(model, state, resize_cross_entropy_loss,
                                  remat=remat, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 64, 128, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 19, (2, 64, 128)))
    y[:, :4] = 255
    with (contextlib.nullcontext() if remat else mbconv.suppress_routing()):
        loss = step(x.to(torch.bfloat16), y)["loss"]
    return (float(loss), {k: v.clone() for k, v in model.state_dict().items()},
            model.dropout_generator.get_state())


@pytest.mark.parametrize("aux", [False, True])
def test_remat_segments_hold_every_parameter_once(aux):
    model = fastscnn(19, aux=aux, upsample_logits=False, seed=0, device="cpu")
    held = [id(p) for seg in model.remat_segments() for p in seg.parameters()]
    assert len(held) == len(set(held))
    assert set(held) == {id(p) for p in model.parameters()}


def test_remat_step_equals_the_step_without_remat(monkeypatch):
    monkeypatch.setattr(tconv, "DEPTHWISE_MIN_PX", 0)
    calls = _spy_wrappers(monkeypatch)
    loss0, state0, gen0 = _port_step(remat=False)
    plain_calls = dict(calls)
    calls.clear()
    loss1, state1, gen1 = _port_step(remat=True)
    # K2 is off in both; the four stride-2 depthwise convs (LDS ds1, ds2,
    # GFE stage1[0], stage2[0]) route K6, and the recompute runs their
    # forwards again
    assert plain_calls == {"depthwise3x3_forward": 4,
                           "depthwise3x3_backward": 4}
    assert calls == {"depthwise3x3_forward": 8, "depthwise3x3_backward": 4}
    assert loss0 == loss1
    assert set(state0) == set(state1)
    for k in state0:
        torch.testing.assert_close(state1[k], state0[k], rtol=0, atol=0,
                                   msg=k)
    assert torch.equal(gen0, gen1)


def test_remat_step_matches_jax():
    """Every parameter and BN statistic at rtol = atol = 1e-4 after two
    steps, losses at rtol 1e-4 (`test_torch_train.py`'s bars)."""
    steps = 2
    j, t = _models()
    jcfg = jtrain.OptimizerConfig(lr=LR, max_steps=4)
    tx = jcfg.make()
    gd, _, jstate = jtrain.create_train_state(j, tx)
    jstep = jtrain.make_train_step(gd, tx, j_resize_ce_loss, remat=True)
    tstate = ttrain.create_train_state(t, ttrain.OptimizerConfig(
        lr=LR, max_steps=4))
    tstep = ttrain.make_train_step(t, tstate, resize_cross_entropy_loss,
                                   remat=True, device="cpu")
    for i, (x, y) in enumerate(_batches(steps), start=1):
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tm = tstep(x, y)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"loss at step {i}")
    _assert_same_state(t, _jax_state_dict(j, gd, jstate), f"step {steps}")
