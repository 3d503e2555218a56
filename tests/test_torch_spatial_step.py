"""PyTorch port, spatial sharding on the CPU: FastSCNN at 2x128x64 with 5
classes on H bands, in gloo ranks (`tests/torch_mp_worker.py`, suite
"spatial:2"): two ranks of one data row (`num_spatial=2`) and four ranks as
2 data rows x 2 bands. Each holds its band of its rows of the global
batch; this process runs the same cases without a group on the whole
batch, and the JAX package runs its own spatial forward.

- The eval forward, the bands put together, against the JAX package's
  forward on a (data 2, spatial 4) mesh of 8 CPU devices, on the JAX
  test's model and input, at its 1e-5; `evaluate`'s matrix on both heads
  (BN calibrated) against this process's.
- One train-mode forward and backward on both routes (full-resolution
  logits with plain CE, the JAX test's; 1/8 logits with the resize CE):
  the loss at 1e-6, the BN statistics, the halo exchanges (34 a step),
  and the parameter gradients,
  summed over ranks, against this process's by relative L2 over the whole
  tree (`spatial_bars.GRAD_TREE_TOL`) and over the classifier, past the
  FFM's ReLU (`HEAD_GRAD_TOL`). `tests/test_torch_spatial_grad.py` holds
  them against the JAX package's float64 gradient.
- The bf16 route (K2's and K1's plain versions on band + halo): the loss
  at 1e-3 and the gradient within the single process's bf16-to-float32
  gap, as `tests/test_torch_parallel_step.py` holds the data-parallel
  bf16 step.
- Two SGD steps through `make_train_step`, and the dropout masks."""

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
from torch_port_util import calibrate_bn
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.data.synthetic import synthetic_batch
from torch_semantic_segmentation_tpu.models import get_model
from torch_semantic_segmentation_tpu.models.fastscnn import (
    fastscnn as j_fastscnn)
from torch_semantic_segmentation_tpu.parallel import (
    batch_sharding, data_parallel_mesh, replicate)
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax

torch.set_num_threads(2)

# the data-parallel bf16 step's loss bar (tests/test_torch_parallel_step.py)
BF16_LOSS_RTOL = 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({"s2": ranks of num_spatial=2, "d2s2": ranks of 2 x 2}, this
    process's results, the JAX package's spatial forward)."""
    out = str(tmp_path_factory.mktemp("spatial"))
    j = j_fastscnn(w.SP_C, upsample_logits=False, rngs=nnx.Rngs(0))
    j.classifier.dropout.rate = 0.0
    torch.save(state_dict_from_jax(export_torch_state_dict(j)),
               f"{out}/init.pt")
    # the JAX package's spatial test's model, in eval mode
    jf = get_model("fastscnn", num_classes=w.SP_C)
    jf.eval()
    torch.save(state_dict_from_jax(export_torch_state_dict(jf)),
               f"{out}/fwd_init.pt")
    je = j_fastscnn(w.SP_C, rngs=nnx.Rngs(1))
    x, y = w.spatial_batch()
    calibrate_bn(je, x)
    torch.save(state_dict_from_jax(export_torch_state_dict(je)),
               f"{out}/eval_init.pt")
    runs_ = {}
    for name, world in (("s2", 2), ("d2s2", 4)):
        sub = f"{out}/{name}"
        os.makedirs(sub)
        for f in ("init.pt", "fwd_init.pt", "eval_init.pt"):
            shutil.copy(f"{out}/{f}", sub)
        runs_[name] = (w.launch("spatial:2", sub, world=world), sub)
    single = w.suite_spatial(out)

    jax_run = {}
    # the JAX package's spatial forward: H over 4, N over 2 (its own test)
    mesh = data_parallel_mesh(num_data=2, num_spatial=4)
    gd, st = nnx.split(jf)
    fwd = jax.jit(lambda st, x: nnx.merge(gd, st)(x))
    xf = jnp.asarray(synthetic_batch(w.SP_N, w.SP_H, w.SP_W, w.SP_C,
                                     seed=7)[0])
    xs = jax.device_put(xf, batch_sharding(mesh, spatial_dim=1,
                                           input_extent=xf.shape[1]))
    jax_run["logits"] = np.asarray(fwd(replicate(st, mesh), xs))
    got = {name: w.collect(procs, sub) for name, (procs, sub) in runs_.items()}
    return got, single, jax_run


@pytest.mark.parametrize("layout", ["s2", "d2s2"])
def test_eval_forward_matches_jax_spatial_mesh(runs, layout):
    got, single, jax_run = runs
    data = 1 if layout == "s2" else 2
    logits = bars.ranks_bands(got[layout], "eval", "logits", data)
    np.testing.assert_allclose(logits.numpy(), jax_run["logits"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(single["eval"]["logits"].numpy(),
                               jax_run["logits"], rtol=1e-5, atol=1e-5)
    for r in got[layout]:
        for up in (True, False):
            assert torch.equal(r["eval"][f"cm_{up}"],
                               single["eval"][f"cm_{up}"]), up
    # each valid pixel counted once
    valid = sum(int((w.spatial_batch(s)[1] != 255).sum()) for s in (8, 9))
    assert int(single["eval"]["cm_True"].sum()) == valid


@pytest.mark.parametrize("layout", ["s2", "d2s2"])
@pytest.mark.parametrize("route", ["full", "low"])
def test_loss_and_gradients_match_the_single_process(runs, layout, route):
    got, single, _ = runs
    key = f"grads_{route}"
    want = single[key]
    for r in got[layout]:
        g = r[key]
        assert torch.equal(g["loss"], got[layout][0][key]["loss"])
        bars.check_loss_and_gradients(g, want["loss"], want["grads"])
        assert int(g["halo_exchanges"]) > 0
        for k, v in want["stats"].items():
            np.testing.assert_allclose(g["stats"][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    data = 1 if layout == "s2" else 2
    dx = bars.ranks_bands(got[layout], key, "dx", data)
    assert dx.shape == want["dx"].shape


# a train step's halo exchanges, forward and backward (the input needs a
# gradient here), as they were before `Conv2d` took the halo that
# `ConvBNAct` used to take for it: its 1x1 convs take none
HALO_EXCHANGES = 34


@pytest.mark.parametrize("layout", ["s2", "d2s2"])
@pytest.mark.parametrize("route", ["full", "low"])
def test_halo_exchanges_a_step(runs, layout, route):
    for r in runs[0][layout]:
        assert int(r[f"grads_{route}"]["halo_exchanges"]) == HALO_EXCHANGES


# PyTorch's CPU kernel for the weight gradient of a bf16 depthwise conv at
# dilation 4 on a channels-last input of 12 rows or more returns other
# values on each call (2 x 12 x 32 x 128 with 3x3 weights: 66 apart between
# two calls on one input; float32, and NCHW bf16, return the same values):
# FFM's dilated depthwise conv reads 16 rows in this process and 12 on a
# band. The card runs cuDNN there; on the CPU that one gradient is left out.
CPU_BF16_UNSTABLE = ("ffm.dwconv.conv.weight",)


@pytest.mark.parametrize("layout", ["s2", "d2s2"])
def test_bf16_route_matches_the_single_process(runs, layout):
    got, single, _ = runs
    want = single["grads_bf16"]
    keys = [k for k in want["grads"] if k not in CPU_BF16_UNSTABLE]
    # the yardstick: the single process's bf16 gradient against its f32 one
    yard = bars.rel_tree(want["grads"], single["grads_low"]["grads"], keys)
    assert int(want["k2_routed"]) == 9       # every GFE block took K2
    for r in got[layout]:
        g = r["grads_bf16"]
        assert int(g["k2_routed"]) == 9
        np.testing.assert_allclose(float(g["loss"]), float(want["loss"]),
                                   rtol=BF16_LOSS_RTOL)
        assert bars.rel_tree(g["grads"], want["grads"], keys) <= yard


@pytest.mark.parametrize("layout", ["s2", "d2s2"])
def test_sgd_steps_through_make_train_step(runs, layout):
    got, single, _ = runs
    want = single["steps"]
    keys = [k for k in want["state2"] if not k.endswith("tracked")]
    for r in got[layout]:
        s = r["steps"]
        assert torch.equal(s["losses"], got[layout][0]["steps"]["losses"])
        np.testing.assert_allclose(s["losses"].numpy(),
                                   want["losses"].numpy(), rtol=1e-5)
        for k in keys:
            np.testing.assert_allclose(s["state2"][k].numpy(),
                                       want["state2"][k].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("layout", ["s2", "d2s2"])
def test_dropout_masks_are_bands_of_the_single_draw(runs, layout):
    got, single, _ = runs
    data = 1 if layout == "s2" else 2
    for name in ("dropout", "spatial"):
        # two draws stacked along N: each rank's halves back in place
        ranks = [r["dropout"][name] for r in got[layout]]
        spatial = len(ranks) // data
        for i, want in enumerate(single["dropout"][name].chunk(2)):
            rows = [torch.cat([ranks[d * spatial + s].chunk(2)[i]
                               for s in range(spatial)], dim=1)
                    for d in range(data)]
            assert torch.equal(torch.cat(rows), want), (name, i)
