"""PyTorch port, spatial sharding of LEDNet and ContextNet on the CPU.

In gloo ranks (`tests/torch_mp_worker.py`, suite "str:S"): four ranks of
one data row (`num_spatial=4`) and four as 2 data rows x 2 bands, each on
its band of its rows of the global batch. LEDNet at 256x64 (its APN's
three stride-2 convs reach 1/64: one row a band there on 4 bands, so the
7x7/s2's 3-row halo and the SSnbt's 3x1 convs dilated up to 17 at 1/8
take their rows from whole bands), ContextNet at 128x64 (one row a band
at 1/32; the x1/4 input resize takes no halo):

- the eval forward, the bands put together, against the JAX package's
  forward of the same weights on a (data 2, spatial 4) mesh of 8 CPU
  devices at 1e-5 (ContextNet's two aux heads too): at 256 rows LEDNet's
  1/64 stage has a row on each of JAX's 4 spatial shards, so its run is
  not degenerate; `evaluate`'s matrix on the fused route (1/8 logits
  through the ×8 resize + argmax) against this process's;
- one train-mode forward and backward on the zoo benches' fused route
  (1/8 logits to the resize CE, dropout on: the bands draw the single
  process's masks) against this process on the global batch of 4 images,
  in float32 at `spatial_bars`' bars, or twice the gap this process's
  own run takes with every BN's batch mean one float32 step up
  (`torch_mp_worker.nudged_moments`) where that is larger, and in float64
  (the gradient and the BN statistics at 1e-10);
- the same on bf16 logits, through K1's plain version on band + one halo
  row: one call a forward on each band as in the single process, the
  loss at the bf16 route's 1e-3, the gradient within the single
  process's bf16-to-float32 gap plus the float32 route's own gap on the
  bands;
- one SGD step through `make_train_step`: the loss at 1e-5 and the state
  after it at `STEP_STATE_TOL` (LEDNet's steps are chaotic after the
  first);
- the halo exchanges a step, `STR_HALO_EXCHANGES`.

The float32 readings sit at the nudge's: LEDNet's loss 1.1e-6 and 2.0e-6
from the single process's (the nudge 1.1e-5), its APN projections'
gradient 1.0e-4 and 1.3e-4 (the nudge 1.8e-4); ContextNet's classifier
gradient 1.1e-3 on 4 bands (the nudge 1.1e-3) and 8.7e-6 on 2 x 2; the
tree 2.0e-3 to 1.0e-2, under `GRAD_TREE_TOL`. LEDNet's BNs at 1/64 take
16 values a channel at this size. In float64 the bands read at most
1e-10 of the single process's gradient.
"""

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
from torch_port_util import jax_zoo_model, randomize_bn
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.data.synthetic import synthetic_batch
from torch_semantic_segmentation_tpu.parallel import (
    batch_sharding, data_parallel_mesh, replicate)
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax

torch.set_num_threads(2)

LAYOUTS = {"s4": (4, 1), "d2s2": (2, 2)}      # name: (spatial, data rows)
# the classifiers, past the last ReLUs: LEDNet's APN projections,
# ContextNet's classifier
HEADS = {"lednet": ("apn.main.", "apn.pool_proj."),
         "contextnet": ("classifier.",)}
# a train step's halo exchanges, forward and backward (the image needs no
# gradient, so the convs on it make no backward exchange), as
# `scripts/spatial_halo_plan.py` counts them for phase 16 too
STR_HALO_EXCHANGES = {"lednet": 123, "contextnet": 44}
# the bf16 route's loss bar (tests/test_torch_spatial_step.py)
BF16_LOSS_RTOL = 1e-3
# the state after one SGD step, rtol = atol: LEDNet's at the bar its step
# against the JAX package's float64 step takes (tests/test_torch_lednet.py,
# 5e-4): its encoder's first weights read 2.4e-4 from the single
# process's, where its float32 gradient sits 1e-2 off by the nudge alone
STEP_STATE_TOL = {"lednet": 5e-4, "contextnet": 1e-4}
# the float32 bars' floor over the nudge's gap (chip_smoke.py's
# SP_GRAD_NOISE)
NUDGE_FACTOR = 2.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({layout: ranks}, this process's results, {model: the JAX package's
    eval outputs on the (2, 4) mesh})."""
    out = str(tmp_path_factory.mktemp("spatial_stretch"))
    jax_models = {}
    for i, name in enumerate(w.STR_MODELS):
        j = jax_zoo_model(name, w.C, seed=20 + i, **w.STR_EVAL_KW[name])
        randomize_bn(j, np.random.default_rng(30 + i))
        j.eval()
        torch.save(state_dict_from_jax(export_torch_state_dict(j)),
                   f"{out}/{name}.pt")
        jax_models[name] = j
    procs = {}
    for layout, (spatial, _) in LAYOUTS.items():
        sub = f"{out}/{layout}"
        os.makedirs(sub)
        for name in w.STR_MODELS:
            shutil.copy(f"{out}/{name}.pt", sub)
        procs[layout] = (w.launch(f"str:{spatial}", sub, world=4), sub)

    mesh = data_parallel_mesh(num_data=2, num_spatial=4)
    jax_run = {}
    for name, j in jax_models.items():
        x = jnp.asarray(synthetic_batch(w.ZOO_N, w.STR_H[name], w.ZOO_W,
                                        w.C, seed=7)[0])
        xs = jax.device_put(x, batch_sharding(mesh, spatial_dim=1,
                                              input_extent=x.shape[1]))
        gd, st = nnx.split(j)
        fwd = jax.jit(lambda st, x, gd=gd: nnx.merge(gd, st)(x))
        y = fwd(replicate(st, mesh), xs)
        jax_run[name] = [np.asarray(t) for t in
                         (y if isinstance(y, (tuple, list)) else [y])]
    single = w.suite_str(out)
    got = {layout: w.collect(p, sub) for layout, (p, sub) in procs.items()}
    return got, single, jax_run


def _together(parts: list, data: int) -> torch.Tensor:
    """The global tensor from the ranks' bands: rank d·S + s holds data
    row d's band s."""
    spatial = len(parts) // data
    return torch.cat([torch.cat(parts[d * spatial:(d + 1) * spatial], dim=1)
                      for d in range(data)])


def _stats_match(got: dict, want: dict, rtol: float, atol: float) -> None:
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", w.STR_MODELS)
def test_eval_forward_matches_jax_spatial_mesh(runs, layout, name):
    got, single, jax_run = runs
    assert len(jax_run[name]) == (3 if name == "contextnet" else 1)
    for i, want in enumerate(jax_run[name]):
        heads = _together([r["eval"][name][i] for r in got[layout]],
                          LAYOUTS[layout][1])
        np.testing.assert_allclose(heads.numpy(), want, rtol=1e-5,
                                   atol=1e-5, err_msg=f"head {i}")
        np.testing.assert_allclose(single["eval"][name][i].numpy(), want,
                                   rtol=1e-5, atol=1e-5, err_msg=f"head {i}")
    cm = single["eval"][f"cm_{name}"]
    valid = sum(int((w.zoo_batch(s, w.ZOO_N, w.STR_H[name])[1] != 255)
                    .sum()) for s in (8, 9))
    assert int(cm.sum()) == valid
    for r in got[layout]:
        assert torch.equal(r["eval"][f"cm_{name}"], cm)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", w.STR_MODELS)
def test_loss_and_gradients_match_the_single_process(runs, layout, name):
    got, single = runs[:2]
    want = single[f"grads_{name}"]
    assert int(want["halo_exchanges"]) == 0
    nudged = single[f"nudged_{name}"]
    head = [k for k in want["grads"] if k.startswith(HEADS[name])]
    loss_rtol = max(bars.LOSS_RTOL, NUDGE_FACTOR * abs(
        float(nudged["loss"]) / float(want["loss"]) - 1))
    head_tol = max(bars.HEAD_GRAD_TOL, NUDGE_FACTOR * bars.rel_tree(
        nudged["grads"], want["grads"], head))
    for r in got[layout]:
        g = r[f"grads_{name}"]
        assert torch.equal(g["loss"], got[layout][0][f"grads_{name}"]["loss"])
        bars.check_loss_and_gradients(g, want["loss"], want["grads"],
                                      head=HEADS[name], loss_rtol=loss_rtol,
                                      head_tol=head_tol)
        assert int(g["halo_exchanges"]) == STR_HALO_EXCHANGES[name]
        assert int(g["k1"]) == 0
        _stats_match(g["stats"], want["stats"], 1e-5, 1e-6)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", w.STR_MODELS)
def test_float64_gradients_match_the_single_process(runs, layout, name):
    """In float64 only the sums' order sets the bands apart: the tree and
    the statistics at 1e-10, the loss (a float32 CE) at 1e-6."""
    got, single = runs[:2]
    want = single[f"grads64_{name}"]
    keys = list(want["grads"])
    assert want["grads"][keys[0]].dtype == torch.float64
    for r in got[layout]:
        g = r[f"grads64_{name}"]
        np.testing.assert_allclose(float(g["loss"]), float(want["loss"]),
                                   rtol=1e-6)
        assert bars.rel_tree(g["grads"], want["grads"], keys) <= 1e-10
        assert int(g["halo_exchanges"]) == STR_HALO_EXCHANGES[name]
        _stats_match(g["stats"], want["stats"], 1e-10, 1e-12)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", w.STR_MODELS)
def test_k1_route_on_bands_matches_the_single_process(runs, layout, name):
    """The 1/8 logits through K1's plain version on each band (one call a
    forward, as in the single process), within the single process's
    bf16-to-float32 gap plus the float32 route's own gap on these bands."""
    got, single = runs[:2]
    want = single[f"grads_{name}_k1"]
    keys = list(want["grads"])
    yard = bars.rel_tree(want["grads"], single[f"grads_{name}"]["grads"],
                         keys)
    assert int(want["k1"]) == 1
    for r in got[layout]:
        g = r[f"grads_{name}_k1"]
        f32_gap = bars.rel_tree(r[f"grads_{name}"]["grads"],
                                single[f"grads_{name}"]["grads"], keys)
        assert bars.rel_tree(g["grads"], want["grads"], keys) <= (
            yard + f32_gap)
        assert int(g["k1"]) == 1
        assert int(g["halo_exchanges"]) == STR_HALO_EXCHANGES[name]
        np.testing.assert_allclose(float(g["loss"]), float(want["loss"]),
                                   rtol=BF16_LOSS_RTOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", w.STR_MODELS)
def test_sgd_step_through_make_train_step(runs, layout, name):
    got, single = runs[:2]
    want = single[f"steps_{name}"]
    keys = [k for k in want["state1"] if not k.endswith("tracked")]
    for r in got[layout]:
        s = r[f"steps_{name}"]
        assert torch.equal(s["losses"],
                           got[layout][0][f"steps_{name}"]["losses"])
        np.testing.assert_allclose(s["losses"].numpy(),
                                   want["losses"].numpy(), rtol=1e-5)
        tol = STEP_STATE_TOL[name]
        for k in keys:
            np.testing.assert_allclose(s["state1"][k].numpy(),
                                       want["state1"][k].numpy(),
                                       rtol=tol, atol=tol, err_msg=k)
