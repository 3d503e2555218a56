"""Helpers for the tests that hold the PyTorch port against the JAX package."""

import contextlib

import jax
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


@contextlib.contextmanager
def jax_x64():
    """float64 in the JAX package within the block, restored after it."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


def jax_model_at(jmodel, dtype):
    """A copy of the JAX model `jmodel`, its own arrays (a train step
    donates them), with every float leaf of its state cast to `dtype`: the
    same draw, computed at `dtype` (flax's layers promote their inputs to
    their parameters' dtype and read `param_dtype` only when they
    initialise). A float64 copy needs `jax_enable_x64`."""
    graph, state = nnx.split(jmodel)
    return nnx.merge(graph, jax.tree.map(
        lambda v: jnp.array(v, dtype) if jnp.issubdtype(v.dtype, jnp.floating)
        else jnp.array(v), state))


def worst_ratio(got, want, tol: float = 1e-4) -> float:
    """The largest |got − want| / (tol + tol·|want|) over every parameter
    and BN statistic of two state dicts: above 1, rtol = atol = `tol`
    fails."""
    return max(float((np.abs(np.asarray(got[k], np.float64)
                             - np.asarray(w, np.float64))
                      / (tol + tol * np.abs(np.asarray(w, np.float64)))
                      ).max())
               for k, w in want.items() if not k.endswith("tracked"))


def sgd_steps(jmodel, tmodel, jloss, tloss, batches, lr: float = 0.002,
              remat: bool = False) -> dict:
    """The JAX weights carried into `tmodel` (float32), then one SGD step of
    each package a batch, the JAX model at its own dtype (float32, or
    float64 by `jax_model_at`): {"start": the state
    both start from, "losses": [(port, JAX) a step], "port", "jax": the
    state dicts after the last step, as numpy float64}."""
    from torch_semantic_segmentation_tpu import train as jtrain
    from torch_semantic_segmentation_tpu_torch import train as ttrain

    start = state_dict_from_jax(export_torch_state_dict(jmodel))
    tmodel.load_state_dict(start, strict=True)
    tx = jtrain.OptimizerConfig(lr=lr, max_steps=4).make()
    gd, _, jstate = jtrain.create_train_state(jmodel, tx)
    jstep = jtrain.make_train_step(gd, tx, jloss, remat=remat)
    tstate = ttrain.create_train_state(tmodel, ttrain.OptimizerConfig(
        lr=lr, max_steps=4))
    tstep = ttrain.make_train_step(tmodel, tstate, tloss, remat=remat,
                                   device="cpu")
    dtype = next(v.dtype for v in jax.tree.leaves(nnx.state(jmodel, nnx.Param))
                 if jnp.issubdtype(v.dtype, jnp.floating))
    losses = []
    for x, y in batches:
        jstate, jm = jstep(jstate, jnp.asarray(x, dtype), jnp.asarray(y))
        losses.append((float(tstep(x, y)["loss"]), float(jm["loss"])))
    want = state_dict_from_jax(export_torch_state_dict(
        nnx.merge(gd, jstate.params, jstate.rest)))
    got = tmodel.state_dict()
    assert set(got) == set(want)

    def f64(sd):
        return {k: v.double().numpy() for k, v in sd.items()}
    return {"start": f64(start), "losses": losses, "port": f64(got),
            "jax": f64(want),
            "parameters": {k for k, _ in tmodel.named_parameters()}}


def movement_gaps(run: dict) -> dict:
    """How far the port's steps moved the model from where the JAX
    package's moved it, as the relative L2 norm ‖Δport − ΔJAX‖ / ‖ΔJAX‖
    of the change from the start over every parameter, and apart over
    every BN statistic: a step that drops the gradient reads 1."""
    def gap(keys):
        d = sum(float(np.sum((run["port"][k] - run["jax"][k]) ** 2))
                for k in keys)
        m = sum(float(np.sum((run["jax"][k] - run["start"][k]) ** 2))
                for k in keys)
        return (d / m) ** 0.5

    stats = {k for k in run["jax"] if k.endswith(("running_mean",
                                                  "running_var"))}
    return {"parameters": gap(run["parameters"]), "BN statistics": gap(stats)}


def sgd_steps_match_jax(jmodel, tmodel, jloss, tloss, batches,
                        lr: float = 0.002, remat: bool = False,
                        state_tol: float = 1e-4) -> dict:
    """`sgd_steps`, asserted: every loss at rtol 1e-4, and after the last
    step every parameter and BN statistic at rtol = atol = `state_tol`
    (1e-4, the bar of tests/test_torch_train.py, unless a test states a
    measured one). Returns `sgd_steps`' record."""
    run = sgd_steps(jmodel, tmodel, jloss, tloss, batches, lr, remat)
    for i, (got, want) in enumerate(run["losses"], start=1):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   err_msg=f"loss at step {i}")
    for k, w in run["jax"].items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(run["port"][k], w, rtol=state_tol,
                                       atol=state_tol, err_msg=k)
    return run


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
