"""PyTorch port, the rematerialised train step (`make_train_step(...,
remat=True)`) on H bands on the CPU, in gloo ranks
(`tests/torch_mp_worker.py`, suite "rem:S"): two ranks of one data row
(`num_spatial=2`) and eight as 2 data rows x 4 bands, each on its band
of its rows of the global batch, against this process without a group.

For FastSCNN (1/8 logits, the resize CE), DeepLabV3-R18 (1/16 logits,
OHEM), UNet (the bilinear decoder: K4's plain version) and ENet (class
weights, spatial dropout), one SGD step from seed 0 with dropout on and
K6 routed (its pixel floor at 0):

- in float32, with the logits in bf16 where a kernel computes the loss
  (K1's and K3's plain versions), the remat step on the bands equals the
  bands' step without remat, K2 suppressed in both, bit for bit: the
  loss, every parameter and BN statistic, and the dropout generators'
  states (the recompute draws the forward's masks, cut by the same
  split, and moves no running statistic). The recompute runs K6's and
  K4's forwards again and exchanges its halos again (`REMAT_HALOS`);
- in float64 the remat step on the bands lies within 1e-10 of this
  process's remat step (its gradients and BN statistics; UNet's gradient
  at float32's rounding, `UNET_F64_GRAD_TOL`, where K4's plain version
  rounds as the kernel does), the running statistics moved once
  (`num_batches_tracked` 1);
- FastSCNN's remat step (the JAX package's weights, float32, no weight
  decay) against the JAX package's `make_train_step(remat=True)` on its
  (data 2, spatial 4) mesh of 8 CPU devices: the loss at
  `spatial_bars.LOSS_RTOL` and the gradient (the step's move over the
  LR) at `spatial_bars`' bars."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import spatial_bars as bars
import torch_mp_worker as w
from torch_semantic_segmentation_tpu import train as jtrain
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.losses import (
    resize_cross_entropy_loss as j_resize_ce)
from torch_semantic_segmentation_tpu.models.fastscnn import (
    fastscnn as j_fastscnn)
from torch_semantic_segmentation_tpu.parallel import (
    batch_sharding, data_parallel_mesh, label_sharding, replicate)
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax

torch.set_num_threads(2)

LAYOUTS = {"s2": (2, 2), "d2s4": (4, 8)}      # name: (spatial, world)
# a step's halo exchanges on every band, without remat and with it: the
# recompute exchanges each checkpointed segment's forward halos again
# (all but the loss's: FastSCNN's K1 halo; ENet is one segment)
PLAIN_HALOS = {"fastscnn": 33, "deeplab": 43, "unet": 43, "enet": 57}
REMAT_HALOS = {"fastscnn": 49, "deeplab": 63, "unet": 65, "enet": 86}
# UNet's float64 gradient against one process's, relative L2 over the
# tree: float32's unit roundoff (6e-8) x 16, where K4's plain version
# rounds its upsample to float32 as the kernel does
UNET_F64_GRAD_TOL = 1e-6


def jax_step(j, x, y, remat: bool):
    """The JAX package's train step (SGD, LR 0.002, no weight decay) on its
    (2, 4) mesh: (loss, the parameters after it)."""
    cfg = jtrain.OptimizerConfig(lr=w.LR, weight_decay=0.0, max_steps=4)
    tx = cfg.make()
    gd, _, state = jtrain.create_train_state(j, tx)
    step = jtrain.make_train_step(gd, tx, j_resize_ce, remat=remat,
                                  donate=False)
    mesh = data_parallel_mesh(num_data=2, num_spatial=4)
    xs = jax.device_put(jnp.asarray(x), batch_sharding(
        mesh, spatial_dim=1, input_extent=x.shape[1]))
    ys = jax.device_put(jnp.asarray(y), label_sharding(mesh, spatial=True))
    new, metrics = step(replicate(state, mesh), xs, ys)
    params = state_dict_from_jax(export_torch_state_dict(
        nnx.merge(gd, new.params, new.rest)))
    return float(metrics["loss"]), params


def step_gradient(after: dict, before: dict) -> dict:
    """A plain SGD step's gradient from the parameters before and after
    it: its first step moves each parameter by −LR times its gradient."""
    return {k: (before[k].double() - after[k].double()) / w.LR
            for k in after}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({layout: ranks}, this process's results, (the JAX package's loss,
    gradient), the initial parameters)."""
    out = str(tmp_path_factory.mktemp("spatial_remat"))
    j = j_fastscnn(w.SP_C, upsample_logits=False, rngs=nnx.Rngs(0))
    j.classifier.dropout.rate = 0.0
    init = state_dict_from_jax(export_torch_state_dict(j))
    torch.save(init, f"{out}/init.pt")
    procs = {}
    for layout, (spatial, world) in LAYOUTS.items():
        sub = f"{out}/{layout}"
        os.makedirs(sub)
        shutil.copy(f"{out}/init.pt", sub)
        procs[layout] = (w.launch(f"rem:{spatial}", sub, world=world), sub)
    single = w.suite_rem(out)
    loss, params = jax_step(j, *w.uneven_batch(w.SP_H), remat=True)
    got = {layout: w.collect(p, sub) for layout, (p, sub) in procs.items()}
    return got, single, (loss, step_gradient(params, init)), init


def whole(ranks: list) -> list:
    """The ranks that keep their states whole (`torch_mp_worker.slim`):
    the first."""
    return ranks[:1]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("key", w.REM_MODELS)
def test_remat_band_step_equals_the_step_without_remat(runs, layout, key):
    got, single, _, _ = runs
    first = got[layout][0][key]
    for r in got[layout]:
        pair = r[key]
        assert torch.equal(pair["loss"], pair["remat_loss"])
        assert torch.equal(pair["loss"], first["loss"])
        assert bool(pair["same_state"]) and bool(pair["same_gens"])
        assert torch.equal(pair["digest"], first["digest"])
        calls = {k: int(v) for k, v in pair["calls"].items()}
        again = {k: int(v) for k, v in pair["remat_calls"].items()}
        # the recompute runs K6's and K4's forwards again; K2 never runs
        want = {k: 2 * v if k in ("k6", "k4") else v
                for k, v in calls.items()}
        assert again == want
        assert "k2" not in calls
    # the kernels' plain versions ran on the bands as in one process
    assert ({k: int(v) for k, v in single[key]["calls"].items()}
            == {k: int(v) for k, v in first["calls"].items()})
    assert {"fastscnn": {"k1", "k6"}, "deeplab": {"k3"}, "unet": {"k4"},
            "enet": set()}[key] == set(single[key]["calls"]) - {"k6_bwd"}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("key", w.REM_MODELS)
def test_remat_band_step_float64_matches_one_process(runs, layout, key):
    got, single, _, _ = runs
    want = single[f"{key}64"]
    for r in got[layout]:
        g = r[f"{key}64"]
        assert torch.equal(g["loss"], got[layout][0][f"{key}64"]["loss"])
        np.testing.assert_allclose(float(g["loss"]), float(want["loss"]),
                                   rtol=1e-6)
        for a, b in zip(g["gens"], want["gens"]):
            assert torch.equal(a, b)
    for r in whole(got[layout]):
        g = r[f"{key}64"]
        for k, v in {**want["state"], **want["grads"]}.items():
            got_k = g["grads"][k] if k in want["grads"] else g["state"][k]
            if k.endswith("num_batches_tracked"):
                # the running statistics moved once
                assert int(g["state"][k]) == int(v) == 1, k
                continue
            if key == "unet" and k in want["grads"]:
                continue
            gap = ((got_k - v).abs() - 1e-10 * (1 + v.abs())).max()
            assert float(gap) <= 0, (k, float(gap))
        if key == "unet":
            # K4's plain version rounds its upsample to float32, as the
            # kernel does (`tests/test_torch_spatial_uneven.py`)
            tree = bars.rel_tree(g["grads"], want["grads"], want["grads"])
            assert tree <= UNET_F64_GRAD_TOL, tree
    # the other ranks hold the same state and gradients: their digests
    for r in got[layout][1:]:
        for part in ("state", "grads"):
            assert torch.equal(r[f"{key}64"][part],
                               w.digest(got[layout][0][f"{key}64"][part]))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("key", w.REM_MODELS)
def test_remat_halo_exchanges(runs, layout, key):
    for r in runs[0][layout]:
        assert int(r[key]["halos"]) == PLAIN_HALOS[key]
        assert int(r[key]["remat_halos"]) == REMAT_HALOS[key]
        assert int(r[f"{key}64"]["halos"]) == REMAT_HALOS[key]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fastscnn_remat_step_matches_jax_mesh(runs, layout):
    got, single, (loss, grads), init = runs
    for res in [single["jax"], *(r["jax"] for r in got[layout])]:
        g = {"loss": res["loss"],
             "grads": step_gradient(res["params"], init)}
        bars.check_loss_and_gradients(g, loss, {k: grads[k]
                                                for k in res["params"]})
