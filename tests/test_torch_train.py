"""PyTorch port, the training step as a whole: full-width FastSCNN
(upsample_logits=False) at 4x64x128 in float32 on the CPU, the JAX weights
carried by `export_torch_state_dict` → `state_dict_from_jax`, dropout rate
0 on both sides (the two frameworks draw different masks). The JAX
`make_train_step(gd, tx, resize_cross_entropy_loss)` and the port's step
take the same batches for 3 SGD steps with max_steps=4, so the poly LR
moves; then one AdamW step. Losses agree at rtol 1e-4; every parameter and
every BN running statistic at rtol = atol = 1e-4 (the bar
tests/test_compat.py holds the JAX zoo to against torch): both sides
compute in float32 and differ in summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu import train as jtrain
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.losses import (
    resize_cross_entropy_loss as j_resize_ce_loss)
from torch_semantic_segmentation_tpu.models.fastscnn import (
    fastscnn as j_fastscnn)
from torch_semantic_segmentation_tpu_torch import train as ttrain
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax
from torch_semantic_segmentation_tpu_torch.losses import (
    resize_cross_entropy_loss)
from torch_semantic_segmentation_tpu_torch.models import fastscnn

torch.set_num_threads(2)

N, H, W, C = 4, 64, 128, 19
# At initialisation the BN-normalised conv weights take gradients as large
# as themselves, and float32 noise of about 5e-5 of a gradient grows some
# 35-fold a step at lr 0.045 (1e-2 apart after 3 steps). A smaller LR keeps
# the steps at about 5e-4 a parameter, five times the bar, and the two
# sides within it; a batch of 4 gives the PPM's 1x1 bin a BN over 4 values
# a channel, where 2 make E[x²]−E[x]² ill-conditioned.
LR = 0.002


def _batches(steps):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(steps):
        x = rng.normal(size=(N, H, W, 3)).astype(np.float32)
        y = rng.integers(0, C, (N, H, W)).astype(np.int32)
        y[:, :4, :9] = 255
        out.append((x, y))
    return out


def _models():
    j = j_fastscnn(C, upsample_logits=False, rngs=nnx.Rngs(0))
    j.classifier.dropout.rate = 0.0
    t = fastscnn(C, upsample_logits=False, device="cpu")
    t.load_state_dict(state_dict_from_jax(export_torch_state_dict(j)),
                      strict=True)
    t.classifier.dropout.rate = 0.0
    return j, t


def _jax_state_dict(j, gd, state) -> dict:
    m = nnx.merge(gd, state.params, state.rest)
    return state_dict_from_jax(export_torch_state_dict(m))


def _assert_same_state(t, want: dict, when: str):
    got = t.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f"{k} after {when}")


# Parameters whose gradient is zero at initialisation, up to float32 noise:
# a BN scale ahead of a ReLU, a depthwise conv and another BN (the BN
# biases start at 0, so scaling the channel changes nothing past that BN),
# and a BN or conv bias ahead of a conv and another BN (a shift the BN
# takes out).
ZERO_GRAD_AT_INIT = frozenset((
    "lds.conv.bn.weight", "lds.ds1.pw.bn.weight", "gfe.ppm.fuse.bn.weight",
    "ffm.low_proj.conv.bias", "ffm.high_proj.conv.bias",
    "classifier.ds1.pw.bn.weight",
    *(f"gfe.stage{s}.{i}.{leaf}" for s in (1, 2, 3) for i in range(3)
      for leaf in ("expand.bn.weight", "project.bn.bias"))))
GRAD_NOISE = 1e3 * np.finfo(np.float32).eps


def _jax_gradient(x, y) -> dict:
    """The JAX package's float32 gradient on the batch, at the initial
    weights, under the torch names."""
    j, _ = _models()
    j.train()
    grad = nnx.jit(lambda m, x, y: nnx.grad(
        lambda m: j_resize_ce_loss(m(x), y))(m))
    nnx.update(j, grad(j, jnp.asarray(x), jnp.asarray(y)))
    return state_dict_from_jax(export_torch_state_dict(j))


def _assert_same_adamw_step(t, want: dict, grad: dict):
    """AdamW's first step moves a parameter by lr·g/(|g|+eps): ±lr whatever
    the size of g. The port's and the JAX package's float32 gradients
    differ by up to 2% of a tensor's scale here (train-mode BN over few
    values a channel amplifies float32 rounding), so an element of a
    gradient under 5% of its tensor's largest may take the other sign,
    and its step then differs by 2·lr. The rest (45% or more of every
    tensor) and the BN running statistics are held at rtol = atol =
    1e-4; the parameters of `ZERO_GRAD_AT_INIT` and the small elements
    at 2·lr + 1e-4."""
    got = t.state_dict()
    assert set(got) == set(want)
    assert {k for k, g in grad.items() if k in dict(t.named_parameters())
            and float(g.abs().max()) <= GRAD_NOISE} == ZERO_GRAD_AT_INIT
    params = dict(t.named_parameters())
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        a, w = got[k].numpy(), w.numpy()
        if k not in params:
            np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-4, err_msg=k)
            continue
        g = np.abs(grad[k].numpy())
        clear = (g > 0.05 * g.max()) & (k not in ZERO_GRAD_AT_INIT)
        np.testing.assert_allclose(a[clear], w[clear], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(a[~clear], w[~clear], rtol=0,
                                   atol=2.0 * LR + 1e-4, err_msg=k)


@pytest.mark.parametrize("optimizer,steps,checks", [
    ("sgd", 3, (1, 3)), ("adamw", 1, (1,))])
def test_train_step_matches_jax(optimizer, steps, checks):
    """SGD: every parameter and BN statistic after steps 1 and 3 at rtol =
    atol = 1e-4. AdamW: the first step as `_assert_same_adamw_step` holds
    it, and the port's gradient against the JAX package's on each
    parameter outside `ZERO_GRAD_AT_INIT` at a relative L2 error of 5e-2
    (2e-2 at most is seen)."""
    j, t = _models()
    jcfg = jtrain.OptimizerConfig(lr=LR, max_steps=4, optimizer=optimizer)
    tcfg = ttrain.OptimizerConfig(lr=LR, max_steps=4, optimizer=optimizer)
    tx = jcfg.make()
    gd, _, jstate = jtrain.create_train_state(j, tx)
    jstep = jtrain.make_train_step(gd, tx, j_resize_ce_loss)
    tstate = ttrain.create_train_state(t, tcfg)
    tstep = ttrain.make_train_step(t, tstate, resize_cross_entropy_loss,
                                   device="cpu")
    batches = _batches(steps)
    grad = _jax_gradient(*batches[0]) if optimizer == "adamw" else None
    for i, (x, y) in enumerate(batches, start=1):
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tm = tstep(x, y)
        assert tm["loss"].device.type == "cpu"
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"loss at step {i}")
        if i not in checks:
            continue
        want = _jax_state_dict(j, gd, jstate)
        if grad is None:
            _assert_same_state(t, want, f"step {i}")
            continue
        _assert_same_adamw_step(t, want, grad)
        for k, p in t.named_parameters():
            if k not in ZERO_GRAD_AT_INIT:
                d = (p.grad.double() - grad[k].double()).norm()
                assert float(d / grad[k].double().norm()) <= 5e-2, k


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_optimizer_update_matches_optax(optimizer):
    """The port's optimizer and schedule against the JAX package's optax
    chain on the same parameters and gradients, 5 updates with
    max_steps=4 (the LR reaches 0 and stays there)."""
    import optax
    rng = np.random.default_rng(3)
    params = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) * 10.0 ** -i
              for p in params] for i in range(5)]
    kw = dict(lr=0.045, max_steps=4, weight_decay=1e-2, optimizer=optimizer)
    tx = jtrain.OptimizerConfig(**kw).make()
    jp = [jnp.asarray(p) for p in params]
    opt = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    state = ttrain.OptimizerConfig(**kw).make(tp)
    for g in grads:
        upd, opt = tx.update([jnp.asarray(a) for a in g], opt, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        state.optimizer.step()
        state.scheduler.step()
        for p, want in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)


def test_poly_schedule_is_closed_form_from_zero():
    cfg = ttrain.OptimizerConfig(lr=0.5, max_steps=4, power=0.9)
    p = torch.nn.Parameter(torch.zeros(1))
    state = cfg.make([p])
    lrs = []
    for _ in range(6):
        lrs.append(state.optimizer.param_groups[0]["lr"])
        state.optimizer.step()
        state.scheduler.step()
    want = [0.5 * (1 - min(t, 4) / 4) ** 0.9 for t in range(6)]
    np.testing.assert_allclose(lrs, want, rtol=1e-12)


def test_train_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = fastscnn(C, upsample_logits=False, device="cpu")
    state = ttrain.create_train_state(t, ttrain.OptimizerConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.make_train_step(t, state)
    with pytest.raises(ValueError, match="optimizer"):
        ttrain.OptimizerConfig(optimizer="lamb").make(t.parameters())


def test_dropout_draws_from_the_model_generator():
    """Train-mode dropout takes its masks from the model's generator, not
    torch's global RNG: reseeding it repeats the step's output exactly."""
    t = fastscnn(C, upsample_logits=False, device="cpu").train()
    x = torch.from_numpy(_batches(1)[0][0])
    outs = []
    for _ in range(2):
        t.dropout_generator.manual_seed(7)
        torch.manual_seed(len(outs))        # the global RNG must not matter
        with torch.no_grad():
            outs.append(t(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert t.classifier.dropout.generator is t.dropout_generator
