"""PyTorch port, the data-parallel training step on the CPU: two gloo ranks
(`tests/torch_mp_worker.py`, suite "step"), each stepping on its half of
every global batch, against this process stepping on the whole batch:

- FastSCNN in float32 (`upsample_logits=False`, dropout rate 0), 2 ranks
  x 2 rows at 64x128 (tests/test_torch_train.py's shape), 3 SGD steps at LR 0.002 with the poly schedule: the
  losses (the same on both ranks) and every parameter and BN statistic
  against the port's single process at rtol = atol = 1e-5 after step 1
  and 1e-4 after step 3 (`F32_STEP3_TOL`), and against the JAX package's
  single-device step on the global batch at tests/test_torch_train.py's
  rtol = atol = 1e-4;
- the bf16 route (K2's and K1's plain versions, W′ and b′ from the global
  folded moments), 2 steps, against the port's single process at the
  bars of `BF16_LOSS_RTOL` and `BF16_HEAD_GAP` and a float32 yardstick;
- ENet with its spatial dropout on (the masks are rows of the global
  draw), 2 steps, against the single process at 1e-5, and its dropout
  generator in step;
- `debug.checked_step` with a NaN pixel in rank 0's rows: both ranks raise
  "non-finite loss" and keep the parameters, the BN statistics, the
  momentum and the schedule bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import torch_mp_worker as w
from torch_semantic_segmentation_tpu import train as jtrain
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.losses import (
    resize_cross_entropy_loss as j_resize_ce_loss)
from torch_semantic_segmentation_tpu.models.fastscnn import (
    fastscnn as j_fastscnn)
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax

torch.set_num_threads(2)

# bf16 against bf16. At initialisation the gradients of the weights ahead
# of a BatchNorm are mostly rounding noise in bf16: the single process's
# bf16 step moves the parameters 0.96 (relative L2) away from where its
# float32 step moves them. Moments summed in two halves differ in the last
# float32 bit, which flips bf16 roundings downstream, so the two-rank step
# lands 0.42 away from the single one (readings on this test's data) and
# cannot be held element by element. Its bars: the losses at 1e-3
# (readings 3.5e-5 and 8.2e-5); after step 1, the classifier's last conv,
# past every BatchNorm, within 0.05 of the single process's movement
# (reading 0.0096), and the whole model's movement no further from the
# single process's than the single process's bf16 step is from its
# float32 one.
BF16_LOSS_RTOL = 1e-3

# float32 after 3 steps: the single process with the global batch's halves
# swapped, which only reorders the BN sums, moves a BN statistic 6.9e-5
# from the unswapped run; the two ranks read 2.1e-5 (this test's data)
F32_STEP3_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_HEAD_GAP = 0.05


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two ranks' results, this process's, the JAX package's losses
    and state dicts after steps 1 and 3)."""
    out = str(tmp_path_factory.mktemp("step"))
    j = j_fastscnn(w.STEP_C, upsample_logits=False, rngs=nnx.Rngs(0))
    j.classifier.dropout.rate = 0.0
    init = f"{out}/init.pt"
    torch.save(state_dict_from_jax(export_torch_state_dict(j)), init)
    procs = w.launch("step", out, world=2)
    single = w.suite_step(out)

    tx = jtrain.OptimizerConfig(lr=w.LR, max_steps=4).make()
    gd, _, jstate = jtrain.create_train_state(j, tx)
    jstep = jtrain.make_train_step(gd, tx, j_resize_ce_loss)
    jax_run = {"losses": []}
    for i, (x, y) in enumerate(w.step_batches(3)):
        jstate, m = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        jax_run["losses"].append(float(m["loss"]))
        if i in (0, 2):
            jax_run[f"state{i + 1}"] = state_dict_from_jax(
                export_torch_state_dict(
                    nnx.merge(gd, jstate.params, jstate.rest)))
    return w.collect(procs, out), single, jax_run


def _same_state(got: dict, want: dict, when: str, **tol):
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                   err_msg=f"{k} after {when}", **tol)


def _check_run(ranks, single, steps, tol, last_tol=None):
    for i, r in enumerate(ranks):
        assert torch.equal(r["losses"], ranks[0]["losses"]), f"rank {i}"
        for s in (1, steps):
            for k, v in single[f"state{s}"].items():
                if k.endswith("num_batches_tracked"):
                    assert torch.equal(r[f"state{s}"][k], v), k
        np.testing.assert_allclose(r["losses"].numpy(),
                                   single["losses"].numpy(), **tol)
        _same_state(r["state1"], single["state1"], f"step 1 on rank {i}",
                    **tol)
        _same_state(r[f"state{steps}"], single[f"state{steps}"],
                    f"step {steps} on rank {i}", **(last_tol or tol))


def test_fastscnn_f32_steps_match_the_single_process(runs):
    ranks, single, _ = runs
    _check_run([r["fastscnn_f32"] for r in ranks], single["fastscnn_f32"],
               3, dict(rtol=1e-5, atol=1e-5), F32_STEP3_TOL)


def test_fastscnn_f32_steps_match_jax(runs):
    ranks, _, jax_run = runs
    for r in ranks:
        got = r["fastscnn_f32"]
        np.testing.assert_allclose(got["losses"].numpy(), jax_run["losses"],
                                   rtol=1e-4)
        for s in (1, 3):
            _same_state(got[f"state{s}"], jax_run[f"state{s}"],
                        f"step {s}", rtol=1e-4, atol=1e-4)


def _movement_gap(got: dict, want: dict, start: dict, keys) -> float:
    """‖Δgot − Δwant‖ / ‖Δwant‖ over `keys`, Δ the move from `start`."""
    d = sum(float((got[k].double() - want[k].double()).norm() ** 2)
            for k in keys)
    m = sum(float((want[k].double() - start[k].double()).norm() ** 2)
            for k in keys)
    return (d / m) ** 0.5


def test_bf16_route_matches_the_single_process(runs):
    ranks, single, _ = runs
    want = single["fastscnn_bf16"]
    start = torch.load(single["init"], weights_only=True)
    params = {k for k, _ in w.fastscnn_model(None).named_parameters()}
    head = {"classifier.conv.weight", "classifier.conv.bias"}
    # the yardstick: the single process's bf16 step against its float32 one
    yard = _movement_gap(want["state1"], single["fastscnn_f32"]["state1"],
                         start, params)
    for i, r in enumerate(ranks):
        got = r["fastscnn_bf16"]
        assert torch.equal(got["losses"], ranks[0]["fastscnn_bf16"]["losses"])
        np.testing.assert_allclose(got["losses"].numpy(),
                                   want["losses"].numpy(),
                                   rtol=BF16_LOSS_RTOL)
        gap = _movement_gap(got["state1"], want["state1"], start, head)
        assert gap <= BF16_HEAD_GAP, f"rank {i}: classifier conv {gap}"
        gap = _movement_gap(got["state1"], want["state1"], start, params)
        assert gap <= yard, f"rank {i}: {gap} against bf16-f32 {yard}"


def test_enet_with_spatial_dropout_matches_the_single_process(runs):
    ranks, single, _ = runs
    _check_run([r["enet"] for r in ranks], single["enet"], 2,
               dict(rtol=1e-5, atol=1e-5))
    for r in ranks:
        assert torch.equal(r["enet"]["dropout_generator"],
                           single["enet"]["dropout_generator"])


def test_checked_step_raises_on_every_rank_and_keeps_the_state(runs):
    ranks, single, _ = runs
    for r in (*ranks, single):
        assert r["checked_nan"]["raised"].startswith("non-finite loss")
        assert bool(r["checked_nan"]["unchanged"])
