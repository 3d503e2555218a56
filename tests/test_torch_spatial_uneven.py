"""PyTorch port, spatial sharding on bands of unequal height on the CPU.

The split (`distributed.split_rows`): where the model's `max_stride`
divides H, whole blocks of max_stride rows dealt as evenly as they go,
the first bands taking one more; any other H (BDD100K's 720 at 32) in
equal rows, as the JAX package's `device_put` splits it. `shard_batch`
refuses what the JAX package refuses (H % num_spatial, the degenerate
split) and nothing else.

In gloo ranks (`tests/torch_mp_worker.py`, suite "unev:S"): two ranks of
one data row (`num_spatial=2`) and eight as 2 data rows x 4 bands, each
on its band of its rows of the global batch, against this process
without a group and the JAX package on its (data 2, spatial 4) mesh of 8
CPU devices, whose shards are equal:

- FastSCNN at 160 rows (5 blocks of 32: bands of 64/32/32/32 and 96/64):
  the eval forward against the JAX package's at 1e-5, as
  `tests/test_parallel.py` holds the JAX mesh against itself, and one
  train step (float32, the resize CE, no weight decay) at
  `spatial_bars`' bars;
- in float64 against one process at 1e-10 (the gradients and the BN
  statistics after one step), each at an odd count of its blocks: FastSCNN at 160 rows, DeepLabV3-R18 with OHEM (the exact top-k
  over bands of unequal size) and UNet's bilinear decoder (K4's plain
  version) at 144 (9 x 16), ENet at CamVid's 360 (45 x 8: 184/176 on two
  bands; UNet's gradient at float32's rounding, `UNET_F64_GRAD_TOL`,
  where K4's plain version rounds to float32 as the kernel does);
  FastSCNN's remat step too;
- FastSCNN's bf16 route through the plain versions of K1, K2 and K6 on
  the unequal bands: the same calls as one process, the loss at 1e-3 and
  the gradient within this process's bf16-to-float32 gap, as
  `tests/test_torch_spatial_step.py` holds the bf16 route;
- the other six zoo models (BiSeNet-R18, ICNet-R18, LEDNet, ContextNet,
  ERFNet, ESNet) at 5 or 9 blocks of their max stride: one forward and
  backward in float64 against one process's at 1e-10;
- FastSCNN's multi-scale + flip step on a 720-row frame (equal bands of
  360, scales of 352, 544, 704, 896, 1088 and 1248 rows, three of them
  an odd count of 32-row blocks): the summed probabilities in float64 at
  1e-10, the matrix equal, each valid pixel counted once."""

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
from test_torch_spatial_remat import (
    UNET_F64_GRAD_TOL, jax_step, step_gradient)
from test_torch_spatial_step import CPU_BF16_UNSTABLE
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.data.synthetic import synthetic_batch
from torch_semantic_segmentation_tpu.models import get_model
from torch_semantic_segmentation_tpu.models.fastscnn import (
    fastscnn as j_fastscnn)
from torch_semantic_segmentation_tpu.parallel import (
    batch_sharding, check_spatial_extent as j_check_spatial_extent,
    data_parallel_mesh, replicate)
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax
from torch_semantic_segmentation_tpu_torch.parallel import (
    distributed, shard_batch)

torch.set_num_threads(2)

LAYOUTS = {"s2": (2, 2, 1), "d2s4": (4, 8, 2)}  # (spatial, world, data)
# (H, bands, max_stride, the split)
SPLITS = [(160, 4, 32, (64, 32, 32, 32)), (192, 4, 32, (64, 64, 32, 32)),
          (224, 4, 32, (64, 64, 64, 32)), (1056, 2, 32, (544, 512)),
          (360, 2, 8, (184, 176)), (720, 2, 32, (360, 360))]
# the multi-scale call's halo exchanges on every band (its two resizes
# and FastSCNN's forward, at 6 scales x 2 flips)
MS_HALOS = 210


@pytest.mark.parametrize("h,n,stride,split", SPLITS)
def test_split_of_every_height(monkeypatch, h, n, stride, split):
    """The split, and `shard_batch`'s bands cut by it and recorded, on
    every band; the JAX package's spatial mesh takes each H."""
    assert distributed.split_rows(h, n, stride) == split
    mesh = data_parallel_mesh(num_data=1, num_spatial=n,
                              devices=jax.devices()[:n])
    xs = jax.device_put(jnp.zeros((1, h, 8, 1)), batch_sharding(
        mesh, spatial_dim=1, input_extent=h, max_stride=stride))
    assert xs.shape == (1, h, 8, 1)
    x = torch.arange(h, dtype=torch.float32).reshape(1, h, 1, 1)
    monkeypatch.setattr(distributed, "num_spatial", lambda: n)
    monkeypatch.setattr(distributed, "world_size", lambda: n)
    monkeypatch.setattr(distributed, "_split", None)
    bands = []
    for s in range(n):
        monkeypatch.setattr(distributed, "rank", lambda s=s: s)
        (band,) = shard_batch((x,), spatial=True, max_stride=stride)
        assert distributed._split == split
        bands.append(band)
    assert [b.shape[1] for b in bands] == list(split)
    assert torch.equal(torch.cat(bands, dim=1), x)


@pytest.mark.parametrize("h,n,stride,refused", [
    (160, 3, 32, "should be divisible by 3, but it is equal to 160"),
    (32, 2, 32, "degenerate spatial sharding"),
    (128, 4, 64, "degenerate spatial sharding"),
    (720, 2, 32, None), (160, 4, 32, None), (96, 3, 32, None)])
def test_refusals_match_jax(monkeypatch, h, n, stride, refused):
    """`shard_batch(spatial=True)` refuses what the JAX package's spatial
    mesh refuses (`device_put` where n does not divide H, its degenerate
    guard), in their words, and takes the rest."""
    mesh = data_parallel_mesh(num_data=1, num_spatial=n,
                              devices=jax.devices()[:n])
    x = np.zeros((1, h, 8, 1), np.float32)
    monkeypatch.setattr(distributed, "num_spatial", lambda: n)
    monkeypatch.setattr(distributed, "world_size", lambda: n)
    monkeypatch.setattr(distributed, "rank", lambda: n - 1)
    monkeypatch.setattr(distributed, "_split", None)
    if refused is None:
        jax.device_put(jnp.asarray(x), batch_sharding(
            mesh, spatial_dim=1, input_extent=h, max_stride=stride))
        (band,) = shard_batch((torch.from_numpy(x),), spatial=True,
                              max_stride=stride)
        assert band.shape[1] == distributed.split_rows(h, n, stride)[-1]
        return
    with pytest.raises(ValueError, match=refused):
        j_check_spatial_extent(h, n, stride)
        jax.device_put(jnp.asarray(x), batch_sharding(
            mesh, spatial_dim=1, input_extent=h, max_stride=stride))
    with pytest.raises(ValueError, match=refused):
        shard_batch((torch.from_numpy(x),), spatial=True, max_stride=stride)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({layout: ranks}, this process's results, the JAX package's eval
    logits and (loss, gradient) of one step, the initial parameters)."""
    out = str(tmp_path_factory.mktemp("spatial_uneven"))
    j = j_fastscnn(w.SP_C, upsample_logits=False, rngs=nnx.Rngs(0))
    j.classifier.dropout.rate = 0.0
    init = state_dict_from_jax(export_torch_state_dict(j))
    torch.save(init, f"{out}/init.pt")
    jf = get_model("fastscnn", num_classes=w.SP_C)
    jf.eval()
    torch.save(state_dict_from_jax(export_torch_state_dict(jf)),
               f"{out}/fwd_init.pt")
    procs = {}
    for layout, (spatial, world, _) in LAYOUTS.items():
        sub = f"{out}/{layout}"
        os.makedirs(sub)
        for f in ("init.pt", "fwd_init.pt"):
            shutil.copy(f"{out}/{f}", sub)
        procs[layout] = (w.launch(f"unev:{spatial}", sub, world=world), sub)
    single = w.suite_unev(out)
    h = w.UNEVEN_H["fastscnn"]
    mesh = data_parallel_mesh(num_data=2, num_spatial=4)
    gd, st = nnx.split(jf)
    fwd = jax.jit(lambda st, x: nnx.merge(gd, st)(x))
    x = jnp.asarray(synthetic_batch(w.SP_N, h, w.SP_W, w.SP_C, seed=7)[0])
    xs = jax.device_put(x, batch_sharding(mesh, spatial_dim=1,
                                          input_extent=h))
    logits = np.asarray(fwd(replicate(st, mesh), xs))
    loss, params = jax_step(j, *w.uneven_batch(h), remat=False)
    got = {layout: w.collect(p, sub) for layout, (p, sub) in procs.items()}
    return got, single, logits, (loss, step_gradient(params, init)), init


def assert_close_tree(got: dict, want: dict, tol: float) -> None:
    """Every tensor of `want` (but BN's batch counts) within tol + tol·|want|
    of `got`'s, elementwise."""
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(v), k
            continue
        gap = (got[k].double() - v.double()).abs() - tol * (1 + v.double().abs())
        assert float(gap.max()) <= 0, (k, float(gap.max()))


def _together(ranks: list, key, part, data: int) -> torch.Tensor:
    return bars.ranks_bands([{key: {part: r[key][part]}} for r in ranks],
                            key, part, data)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_eval_forward_matches_jax_spatial_mesh(runs, layout):
    got, single, logits, _, _ = runs
    spatial, _, data = LAYOUTS[layout]
    want = distributed.split_rows(w.UNEVEN_H["fastscnn"], spatial, 32)
    for r in got[layout]:
        assert tuple(r["eval"]["split"].tolist()) == want
    together = _together(got[layout], "eval", "logits", data)
    np.testing.assert_allclose(together.numpy(), logits, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(single["eval"]["logits"].numpy(), logits,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_train_step_matches_jax_mesh(runs, layout):
    got, single, _, (loss, grads), init = runs
    for res in [single["jax"], *(r["jax"] for r in got[layout])]:
        g = {"loss": res["loss"],
             "grads": step_gradient(res["params"], init)}
        bars.check_loss_and_gradients(g, loss, {k: grads[k]
                                                for k in res["params"]})


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("key", [*w.REM_MODELS, "fastscnn_remat"])
def test_float64_matches_one_process(runs, layout, key):
    got, single, _, _, _ = runs
    want = single[f"{key}64"]
    ranks = got[layout]
    for r in ranks:
        g = r[f"{key}64"]
        assert torch.equal(g["loss"], ranks[0][f"{key}64"]["loss"])
        np.testing.assert_allclose(float(g["loss"]), float(want["loss"]),
                                   rtol=1e-6)
        assert {k: int(v) for k, v in g["calls"].items()} == {
            k: int(v) for k, v in want["calls"].items()}
    # the other ranks hold the first's state and gradients
    # (`torch_mp_worker.slim`): their digests
    for r in ranks[1:]:
        for part in ("state", "grads"):
            assert torch.equal(r[f"{key}64"][part],
                               w.digest(ranks[0][f"{key}64"][part]))
    for r in ranks[:1]:
        g = r[f"{key}64"]
        assert_close_tree(g["state"], want["state"], 1e-10)
        if key == "unet":
            # K4's plain version rounds its upsample to float32, as the
            # kernel does: the gradients meet at float32's rounding
            # (readings 2.7e-8)
            tree = bars.rel_tree(g["grads"], want["grads"], want["grads"])
            assert tree <= UNET_F64_GRAD_TOL, tree
        else:
            assert_close_tree(g["grads"], want["grads"], 1e-10)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_bf16_route_through_the_plain_kernels(runs, layout):
    got, single, _, _, _ = runs
    want = single["fastscnn_bf16"]
    calls = {k: int(v) for k, v in want["calls"].items()}
    # K1 once, K2 at each GFE block, K6 at the LDS's stride-2 depthwise
    # conv whose input is bf16 (the first takes the float32 image)
    assert calls == {"k1": 1, "k2": 9, "k6": 1, "k6_bwd": 1}
    keys = [k for k in want["grads"] if k not in CPU_BF16_UNSTABLE]
    yard = bars.rel_tree(want["grads"], single["fastscnn_f32"]["grads"],
                         keys)
    for r in got[layout]:
        g = r["fastscnn_bf16"]
        assert {k: int(v) for k, v in g["calls"].items()} == calls
        np.testing.assert_allclose(float(g["loss"]), float(want["loss"]),
                                   rtol=1e-3)
        assert bars.rel_tree(g["grads"], want["grads"], keys) <= yard


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_multiscale_counts_each_pixel_once(runs, layout):
    got, single, _, _, _ = runs
    want = single["ms64"]
    data = LAYOUTS[layout][2]
    probs = bars.ranks_bands([{"ms": {"p": r["ms64"]["probs"]}}
                              for r in got[layout]], "ms", "p", data)
    np.testing.assert_allclose(probs.numpy(), want["probs"].numpy(),
                               rtol=1e-10, atol=1e-10)
    assert int(want["cm"].sum()) == int(want["valid"])
    for r in got[layout]:
        assert torch.equal(r["ms64"]["cm"], want["cm"])
        assert int(r["ms64"]["halos"]) == MS_HALOS


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(w.UNEVEN_ZOO))
def test_float64_zoo_on_unequal_bands(runs, layout, name):
    got, single, _, _, _ = runs
    want = single[f"zoo_{name}"]
    ranks = got[layout]
    for r in ranks:
        np.testing.assert_allclose(float(r[f"zoo_{name}"]["loss"]),
                                   float(want["loss"]), rtol=1e-6)
    for r in ranks[1:]:
        for part in ("state", "grads"):
            assert torch.equal(r[f"zoo_{name}"][part],
                               w.digest(ranks[0][f"zoo_{name}"][part]))
    for r in ranks[:1]:
        assert_close_tree(r[f"zoo_{name}"]["grads"], want["grads"], 1e-10)
        assert_close_tree(r[f"zoo_{name}"]["state"], want["state"], 1e-10)
