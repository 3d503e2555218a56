"""PyTorch port, spatial sharding of DeepLabV3 and UNet on the CPU: train
steps on H bands against one process. In gloo ranks
(`tests/torch_mp_worker.py`, suite "zoo:S:step"): four ranks of one data
row (`num_spatial=4`, bands of 32 rows, 2 rows at 1/16, so ASPP's rate-18
halo reaches past every band) and four as 2 data rows x 2 bands, each on
its band of its rows of a global batch of 4x128x64 with 5 classes
(DeepLabV3-ResNet18 and UNet at base 8, from seed 0, dropout on: the bands
draw the single process's masks). This process runs the same cases
without a group.

- One train-mode forward and backward on each route: DeepLab's OHEM
  (thresh 0.2 and min_kept 60% of the pixels, so that min_kept decides) on
  its 1/16 logits (the exact top-k over `all_gather`), with its aux head
  (two heads through `aux_weighted_loss`), and on full-resolution logits
  by bisection (`ohem_cross_entropy(exact=False)`: `reduce_max` and 26
  `reduce_sum`s); UNet's two decoders with CE. The loss at
  `spatial_bars.LOSS_RTOL`, the summed gradient over the tree at
  `GRAD_TREE_TOL` and over the classifier at `HEAD_GRAD_TOL`, the BN
  statistics at rtol 1e-5, atol 1e-6, and the halo exchanges a step.
- The aux route on bf16 logits, where both heads go through K3's plain
  version on band + one halo row: the loss at the bf16 route's 1e-3, the
  gradient within the single process's bf16-to-float32 gap (as
  `tests/test_torch_spatial_step.py` holds FastSCNN's bf16 route).
- ASPP alone in train mode on well-separated images: its output, input
  gradient, parameter gradients and the image-level branch's BN
  statistics (the same N values a channel on every band of a data row,
  each rank weighed 1/R) against one process. In DeepLab the branch's 4
  values a channel lie close together, and its E[x²]−E[x]² amplifies
  float32 noise (its gradient reads 1e-4 to 2e-3 there), so the tight bar
  is held here.
- Two SGD steps through `make_train_step` of DeepLab's OHEM route and of
  UNet's bilinear decoder."""

import os

import numpy as np
import pytest
import torch

import spatial_bars as bars
import torch_mp_worker as w

torch.set_num_threads(2)

LAYOUTS = {"s4": (4, 1), "d2s2": (2, 2)}      # name: (spatial, data rows)
HEADS = {"deeplab": ("classifier.", "aux_head.classifier."),
         "unet": ("head.",)}
# the bf16 route's loss bar (tests/test_torch_spatial_step.py)
BF16_LOSS_RTOL = 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({layout: ranks}, this process's results)."""
    out = str(tmp_path_factory.mktemp("spatial_zoo_step"))
    procs = {}
    for name, (spatial, _) in LAYOUTS.items():
        sub = f"{out}/{name}"
        os.makedirs(sub)
        procs[name] = (w.launch(f"zoo:{spatial}:step", sub, world=4), sub)
    single = w.suite_zoo_step()
    return {name: w.collect(p, sub) for name, (p, sub) in procs.items()}, \
        single


def _stats_match(got: dict, want: dict) -> None:
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("route", [r for r in w.ZOO_ROUTES
                                   if not r.endswith("k3")])
def test_loss_and_gradients_match_the_single_process(runs, layout, route):
    got, single = runs
    key = f"grads_{route}"
    want = single[key]
    for r in got[layout]:
        g = r[key]
        assert torch.equal(g["loss"], got[layout][0][key]["loss"])
        bars.check_loss_and_gradients(g, want["loss"], want["grads"],
                                      head=HEADS[route.split("_")[0]])
        assert int(g["halo_exchanges"]) > 0 and int(g["k3"]) == 0
        _stats_match(g["stats"], want["stats"])


# a train step's halo exchanges, forward and backward (the image needs no
# gradient), as they were before `Conv2d` took the halo that `ConvBNAct`
# used to take for it: the raw convs of DeepLab and UNet are 1x1s, which
# take none
HALO_EXCHANGES = {"deeplab_exact": 43, "deeplab_aux": 47,
                  "deeplab_aux_k3": 47, "deeplab_bisect": 43,
                  "unet_deconv": 35, "unet_bilinear": 43}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("route", w.ZOO_ROUTES)
def test_halo_exchanges_a_step(runs, layout, route):
    for r in runs[0][layout]:
        assert int(r[f"grads_{route}"]["halo_exchanges"]) == \
            HALO_EXCHANGES[route]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_k3_route_on_bands_matches_the_single_process(runs, layout):
    """Both heads through K3's plain version on each band (two calls a
    forward, as in the single process), within the single process's
    bf16-to-float32 gap."""
    got, single = runs
    want = single["grads_deeplab_aux_k3"]
    keys = list(want["grads"])
    yard = bars.rel_tree(want["grads"], single["grads_deeplab_aux"]["grads"],
                         keys)
    assert int(want["k3"]) == 2
    for r in got[layout]:
        g = r["grads_deeplab_aux_k3"]
        assert int(g["k3"]) == 2
        np.testing.assert_allclose(float(g["loss"]), float(want["loss"]),
                                   rtol=BF16_LOSS_RTOL)
        assert bars.rel_tree(g["grads"], want["grads"], keys) <= yard


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_aspp_image_level_branch_matches_the_single_process(runs, layout):
    got, single = runs
    spatial, data = LAYOUTS[layout]
    want = single["aspp"]
    ranks = [r["aspp"] for r in got[layout]]

    def together(part):
        return torch.cat([torch.cat([ranks[d * spatial + s][part]
                                     for s in range(spatial)], dim=1)
                          for d in range(data)])

    torch.testing.assert_close(together("y"), want["y"], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(together("dx"), want["dx"], rtol=1e-5,
                               atol=1e-5)
    branch = [k for k in want["grads"] if k.startswith("image_pool.")]
    for r in ranks:
        assert bars.rel_tree(r["grads"], want["grads"],
                             list(want["grads"])) <= bars.HEAD_GRAD_TOL
        assert bars.rel_tree(r["grads"], want["grads"],
                             branch) <= bars.HEAD_GRAD_TOL
        _stats_match(r["stats"], want["stats"])


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("route", w.ZOO_STEP_ROUTES)
def test_sgd_steps_through_make_train_step(runs, layout, route):
    got, single = runs
    want = single[f"steps_{route}"]
    keys = [k for k in want["state2"] if not k.endswith("tracked")]
    for r in got[layout]:
        s = r[f"steps_{route}"]
        assert torch.equal(s["losses"],
                           got[layout][0][f"steps_{route}"]["losses"])
        np.testing.assert_allclose(s["losses"].numpy(),
                                   want["losses"].numpy(), rtol=1e-5)
        for k in keys:
            np.testing.assert_allclose(s["state2"][k].numpy(),
                                       want["state2"][k].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
