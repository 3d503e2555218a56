"""PyTorch port, spatial sharding on the CPU against the JAX package's
unsharded gradient: FastSCNN at 2x128x64 with 5 classes on H bands, in
gloo ranks (`tests/torch_mp_worker.py`, suite "spatial:2:grads": two ranks
of one data row, and 2 data rows x 2 bands), one train-mode forward and
backward on both routes (full-resolution logits with plain CE, the JAX
package's spatial test's route; 1/8 logits with the resize CE). The JAX
package's own spatial test needs float64 to tell reassociation from a
fault; the port computes in float32 (its BatchNorm, pools and resizes
accumulate in float32), so the gradients summed over ranks, and this
process's without a group, meet the JAX package's float64 gradient at the
bars of `tests/spatial_bars.py`, derived from the readings there."""

import os
import shutil

import jax
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

import spatial_bars as bars
import torch_mp_worker as w
from torch_port_util import jax_model_at, jax_x64
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.losses import (
    cross_entropy_loss as j_ce, resize_cross_entropy_loss as j_resize_ce)
from torch_semantic_segmentation_tpu.models.fastscnn import (
    fastscnn as j_fastscnn)
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({"s2": ranks, "d2s2": ranks}, this process's gradients, {route:
    (the JAX package's float64 loss, its gradient)})."""
    out = str(tmp_path_factory.mktemp("spatial_grad"))
    j = j_fastscnn(w.SP_C, upsample_logits=False, rngs=nnx.Rngs(0))
    j.classifier.dropout.rate = 0.0
    torch.save(state_dict_from_jax(export_torch_state_dict(j)),
               f"{out}/init.pt")
    procs = {}
    for name, world in (("s2", 2), ("d2s2", 4)):
        sub = f"{out}/{name}"
        os.makedirs(sub)
        shutil.copy(f"{out}/init.pt", sub)
        procs[name] = (w.launch("spatial:2:grads", sub, world=world), sub)
    single = w.suite_spatial(out, grads_only=True)
    x, y = w.spatial_batch()
    jax_run = {}
    with jax_x64():
        for route, up, loss in (("full", True, j_ce),
                                ("low", False, j_resize_ce)):
            jm = jax_model_at(j, jnp.float64)
            jm.upsample_logits = up
            jm.train()
            gd, st = nnx.split(jm)

            def loss_of(state, x, y, _gd=gd, _loss=loss):
                return _loss(nnx.merge(_gd, state)(x), y)

            lv, g = jax.jit(jax.value_and_grad(loss_of, allow_int=True))(
                st, jnp.asarray(x, jnp.float64), jnp.asarray(y))
            sd = state_dict_from_jax(export_torch_state_dict(
                nnx.merge(gd, g)))
            jax_run[route] = (float(lv), sd)
    got = {name: w.collect(p, sub) for name, (p, sub) in procs.items()}
    return got, single, jax_run


@pytest.mark.parametrize("route", ["full", "low"])
def test_single_process_gradient_meets_jax_float64(runs, route):
    _, single, jax_run = runs
    loss, grads = jax_run[route]
    g = single[f"grads_{route}"]
    bars.check_loss_and_gradients(g, loss, {k: grads[k] for k in g["grads"]})


@pytest.mark.parametrize("layout", ["s2", "d2s2"])
@pytest.mark.parametrize("route", ["full", "low"])
def test_spatial_gradient_meets_jax_float64(runs, layout, route):
    got, _, jax_run = runs
    loss, grads = jax_run[route]
    for r in got[layout]:
        g = r[f"grads_{route}"]
        bars.check_loss_and_gradients(g, loss,
                                      {k: grads[k] for k in g["grads"]})
