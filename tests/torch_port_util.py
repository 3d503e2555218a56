"""Helpers for the tests that hold the PyTorch port against the JAX package."""

import jax.numpy as jnp
import numpy as np
from flax import nnx

from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax


def randomize_bn(jmodule, rng: np.random.Generator):
    """Random running stats and affine params on every JAX BatchNorm, so
    that eval mode and folding are not the identity."""
    for _, m in nnx.iter_graph(jmodule):
        if isinstance(m, nnx.BatchNorm):
            m.mean[...] = jnp.asarray(
                rng.normal(0, 0.5, m.mean.shape).astype(np.float32))
            m.var[...] = jnp.asarray(
                rng.uniform(0.5, 2.0, m.var.shape).astype(np.float32))
            m.scale[...] = jnp.asarray(
                rng.uniform(0.5, 1.5, m.scale.shape).astype(np.float32))
            m.bias[...] = jnp.asarray(
                rng.normal(0, 0.2, m.bias.shape).astype(np.float32))


def calibrate_bn(jmodule, x, seed: int = 0):
    """Running stats of every JAX BatchNorm set to the batch statistics of
    one train-mode forward pass over `x`, and random affine params: the
    activations keep their scale through the random layers, so the ids of
    a segmentation model vary over the image (random running stats make
    them constant). Leaves the module in eval mode."""
    rng = np.random.default_rng(seed)
    bns = [m for _, m in nnx.iter_graph(jmodule) if isinstance(m, nnx.BatchNorm)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 0.0
        m.scale[...] = jnp.asarray(
            rng.uniform(0.5, 1.5, m.scale.shape).astype(np.float32))
        m.bias[...] = jnp.asarray(
            rng.normal(0, 0.2, m.bias.shape).astype(np.float32))
    jmodule.train()
    jmodule(jnp.asarray(x))
    for m, momentum in zip(bns, saved):
        m.momentum = momentum
    jmodule.eval()


def carry_weights(jmodule, tmodule, seed: int = 0):
    """Random BN stats on the JAX module, both modules in eval mode, and
    the JAX weights loaded into the port's module with strict=True."""
    randomize_bn(jmodule, np.random.default_rng(seed))
    jmodule.eval()
    tmodule.load_state_dict(
        state_dict_from_jax(export_torch_state_dict(jmodule)), strict=True)
    return tmodule.eval()


def sgd_steps_match_jax(jmodel, tmodel, jloss, tloss, batches,
                        lr: float = 0.002, remat: bool = False):
    """The JAX weights carried into `tmodel`, then one SGD step of each
    package a batch: every loss at rtol 1e-4, and after the last step every
    parameter and BN statistic at rtol = atol = 1e-4 (the bar of
    tests/test_torch_train.py)."""
    from torch_semantic_segmentation_tpu import train as jtrain
    from torch_semantic_segmentation_tpu_torch import train as ttrain

    tmodel.load_state_dict(
        state_dict_from_jax(export_torch_state_dict(jmodel)), strict=True)
    tx = jtrain.OptimizerConfig(lr=lr, max_steps=4).make()
    gd, _, jstate = jtrain.create_train_state(jmodel, tx)
    jstep = jtrain.make_train_step(gd, tx, jloss, remat=remat)
    tstate = ttrain.create_train_state(tmodel, ttrain.OptimizerConfig(
        lr=lr, max_steps=4))
    tstep = ttrain.make_train_step(tmodel, tstate, tloss, remat=remat,
                                   device="cpu")
    for i, (x, y) in enumerate(batches, start=1):
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tm = tstep(x, y)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"loss at step {i}")
    want = state_dict_from_jax(export_torch_state_dict(
        nnx.merge(gd, jstate.params, jstate.rest)))
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)


def remat_step_is_bit_exact(make_model, loss_fn, x, y):
    """One SGD step of the port from the same seed with and without
    `remat=True`: the loss, every gradient, every parameter and BN
    statistic, and the dropout generator's state equal bit for bit."""
    import torch

    from torch_semantic_segmentation_tpu_torch import train as ttrain

    def run(remat):
        model = make_model()
        state = ttrain.create_train_state(model,
                                          ttrain.OptimizerConfig(lr=0.01))
        step = ttrain.make_train_step(model, state, loss_fn, remat=remat,
                                      device="cpu")
        loss = float(step(x, y)["loss"])
        gen = getattr(model, "dropout_generator", None)
        return (loss, {k: p.grad.clone() for k, p in model.named_parameters()},
                {k: v.clone() for k, v in model.state_dict().items()},
                None if gen is None else gen.get_state())

    loss0, grads0, state0, gen0 = run(False)
    loss1, grads1, state1, gen1 = run(True)
    assert loss0 == loss1
    assert set(grads0) == set(grads1) and set(state0) == set(state1)
    for k in grads0:
        assert torch.equal(grads0[k], grads1[k]), f"gradient {k}"
    for k in state0:
        assert torch.equal(state0[k], state1[k]), k
    if gen0 is not None:
        assert torch.equal(gen0, gen1)


def aux_ohem_losses(handles_resize: bool, **ohem):
    """(JAX loss, port loss) of a model's outputs, composed as the JAX
    package's `cli/common.build_loss` composes them: OHEM on each head
    (`resize_ohem_cross_entropy`, which handles the resize, or
    `ohem_cross_entropy` on heads resized first) in a `SegLoss`, main + 1.0
    · aux through `aux_weighted_loss`."""
    import functools

    from torch_semantic_segmentation_tpu import losses as jlosses
    from torch_semantic_segmentation_tpu_torch import losses as tlosses

    name = ("resize_ohem_cross_entropy" if handles_resize
            else "ohem_cross_entropy")
    jbase = jlosses.SegLoss(functools.partial(getattr(jlosses, name), **ohem),
                            handles_resize=handles_resize)
    tbase = tlosses.SegLoss(functools.partial(getattr(tlosses, name), **ohem),
                            handles_resize=handles_resize)
    return (lambda outs, lb: jlosses.aux_weighted_loss(
                outs, lb, loss_fn=jbase, aux_weight=1.0),
            lambda outs, lb: tlosses.aux_weighted_loss(
                outs, lb, loss_fn=tbase, aux_weight=1.0))
