"""PyTorch port, spatial sharding of BiSeNet and ICNet on the CPU.

In gloo ranks (`tests/torch_mp_worker.py`, suite "cas:S"): four ranks of
one data row (`num_spatial=4`, bands of 32 rows: one row at 1/32, so
ICNet's pyramid pooling bins and every 3x3 at 1/32 take their halo from
whole bands) and four as 2 data rows x 2 bands, each on its band of its
rows of the global batch. Both models on ResNet-18 at 128x64:

- the eval forward's three heads, the bands put together, against the
  JAX package's forward of the same weights on a (data 2, spatial 4)
  mesh of 8 CPU devices, on the JAX spatial test's input at its 1e-5;
  `evaluate`'s matrix on config 5's route (1/8 or 1/4 main head through
  the ×k resize + argmax) against this process's;
- one train-mode forward and backward on config 5's route (1/8, 1/8 and
  1/16 heads for BiSeNet, 1/4, 1/8 and 1/16 for ICNet, each to OHEM at
  its own ratio through `aux_weighted_loss`, aux weight 1.0; OHEM at
  thresh 0.2 and min_kept 60% of the pixels, so that min_kept decides)
  against this process on the global batch of 4x128x64, in float32: the
  loss at `spatial_bars.LOSS_RTOL`, the summed gradient over the tree at
  `GRAD_TREE_TOL` and over the three classifiers at `HEAD_GRAD_TOL`, the
  BN statistics at rtol 1e-5, atol 1e-6; and in float64, the gradient
  and the statistics at 1e-10;
- the same on bf16 logits, where each head goes through K3's plain
  version on band + one halo row (x8, x8, x16 and x4, x8, x16): three
  calls a forward on each band as in the single process, the loss at the
  bf16 route's 1e-3, the gradient within the single process's
  bf16-to-float32 gap plus the float32 route's own gap on the bands;
- one SGD step through `make_train_step`: the loss at 1e-5 and the state
  after it at 1e-4;
- the halo exchanges a step, `CAS_HALO_EXCHANGES`.

Every rank holds the same summed gradients and state after the step:
rank 0's are held whole, each other rank's by its digest against rank
0's (`torch_mp_worker.digest`).

The float32 band gradients read 7.6e-4 (BiSeNet) and 1.1e-2 (ICNet)
from the single process's by relative L2 over the tree, the float64 ones
6.9e-14 and 3.2e-14: in float32 the sums of the bands' BN moments in
another order move values within rounding of a ReLU's zero or a
near-tied max pool. The float64 runs need the global means, the pools
and the resizes to keep float64 (they accumulate float32 otherwise,
whose sums of the bands' parts would leave them 1e-7 apart).

In this process, on the bands of one tensor (`Bands` of
`tests/test_torch_spatial.py`): ICNet's integer downsampling resize at
x1/2 and x1/4, bit for bit with the unsharded rows forward and backward,
and each geometry a band's resize refuses; BiSeNet's ARM and FFM alone
in train mode in float64, their sums over the bands (the global means
and the BN moments) made real sums of every band's part
(`SummedBands`), the gate parameters' gradients at 1e-10: a band's
partial mean counted once per band would read S times too large there.
"""

import contextlib
import copy
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
from test_torch_spatial import Bands, _rng_tensor
from torch_port_util import jax_zoo_model, randomize_bn
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.data.synthetic import synthetic_batch
from torch_semantic_segmentation_tpu.parallel import (
    batch_sharding, data_parallel_mesh, replicate)
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax
from torch_semantic_segmentation_tpu_torch.models.bisenet import (
    AttentionRefinement, FeatureFusionModule)
from torch_semantic_segmentation_tpu_torch.ops import upsample
from torch_semantic_segmentation_tpu_torch.parallel import distributed

torch.set_num_threads(2)

LAYOUTS = {"s4": (4, 1), "d2s2": (2, 2)}      # name: (spatial, data rows)
HEADS = {"bisenet": ("head.cls.", "aux_head16.cls.", "aux_head32.cls."),
         "icnet": ("classifier.", "aux_cls1.", "aux_cls2.")}
# a train step's halo exchanges, forward and backward (the image needs no
# gradient, so the convs on it make no backward exchange; the x1/2
# resizes take none), as `scripts/spatial_halo_plan.py` counts them for
# phase 16's BiSeNet-R18 and ICNet-R50 too: BiSeNet 33 + 31 (the spatial
# path's 7x7 and two 3x3s; the ResNet's stem, max pool and 16 3x3s; the
# ARMs', refines' and heads' seven 3x3s; two x2 upsamples; the three
# heads' K3 halo rows; backward all but the spatial path's 7x7 and the
# stem), ICNet 29 + 27 (sub1's three 3x3s; the stem, max pool and 16
# 3x3s; the CFFs' two dilated 3x3s and two x2 upsamples, the x2 before
# the classifier; the three heads' halo rows; backward all but sub1's
# first conv and the stem, on the image and its x1/2)
CAS_HALO_EXCHANGES = {"bisenet": 64, "icnet": 56}
# the bf16 route's loss bar (tests/test_torch_spatial_step.py)
BF16_LOSS_RTOL = 1e-3
# the three classifiers' float32 gradient on the OHEM route, relative L2:
# read 4.2e-6 (BiSeNet) and 2.2e-6 (ICNet) on 4 bands, but 2.6e-4 and
# 1.7e-4 on 2 x 2, where OHEM keeps another pixel at its k-th largest
# loss: the single process's k-th and k+1-th losses of ICNet's 1/8 head
# lie 2.7e-6 apart (1.5353923, 1.5353895), and the bands' float32 losses
# move 2.9e-6 from them, so the two swap. `spatial_bars.HEAD_GRAD_TOL`
# (1e-4) sits under one swap; this bar 4x above the readings, 360x under
# the nearest fault of `spatial_bars` (0.36). The float64 run holds the
# heads at 1e-10.
OHEM_HEAD_GRAD_TOL = 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({layout: ranks}, this process's results, {model: the JAX package's
    three heads on the (2, 4) mesh})."""
    out = str(tmp_path_factory.mktemp("spatial_cascade"))
    jax_models = {}
    for i, name in enumerate(w.CAS_MODELS):
        j = jax_zoo_model(name, w.C, seed=20 + i, depth=18)
        randomize_bn(j, np.random.default_rng(30 + i))
        j.eval()
        torch.save(state_dict_from_jax(export_torch_state_dict(j)),
                   f"{out}/{name}.pt")
        jax_models[name] = j
    procs = {}
    for layout, (spatial, _) in LAYOUTS.items():
        sub = f"{out}/{layout}"
        os.makedirs(sub)
        for name in w.CAS_MODELS:
            shutil.copy(f"{out}/{name}.pt", sub)
        procs[layout] = (w.launch(f"cas:{spatial}", sub, world=4), sub)

    mesh = data_parallel_mesh(num_data=2, num_spatial=4)
    x = jnp.asarray(synthetic_batch(w.ZOO_N, w.ZOO_H, w.ZOO_W, w.C,
                                    seed=7)[0])
    xs = jax.device_put(x, batch_sharding(mesh, spatial_dim=1,
                                          input_extent=x.shape[1]))
    jax_run = {}
    for name, j in jax_models.items():
        gd, st = nnx.split(j)
        fwd = jax.jit(lambda st, x, gd=gd: nnx.merge(gd, st)(x))
        jax_run[name] = [np.asarray(h) for h in fwd(replicate(st, mesh), xs)]
    single = w.suite_cas(out)
    got = {layout: w.collect(p, sub) for layout, (p, sub) in procs.items()}
    return got, single, jax_run


def _together(parts: list, data: int) -> torch.Tensor:
    """The global tensor from the ranks' bands: rank d·S + s holds data
    row d's band s."""
    spatial = len(parts) // data
    return torch.cat([torch.cat(parts[d * spatial:(d + 1) * spatial], dim=1)
                      for d in range(data)])


def _whole(ranks: list, key: str, part: str) -> dict:
    """Rank 0's `part` of case `key` (the summed gradients or the state
    after a step, which every rank holds alike), after checking that every
    other rank's digest of it equals rank 0's."""
    whole = ranks[0][key][part]
    for r in ranks[1:]:
        assert torch.equal(r[key][part], w.digest(whole))
    return whole


def _stats_match(got: dict, want: dict, rtol: float, atol: float) -> None:
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", w.CAS_MODELS)
def test_eval_forward_matches_jax_spatial_mesh(runs, layout, name):
    got, single, jax_run = runs
    assert len(jax_run[name]) == 3
    for i, want in enumerate(jax_run[name]):
        heads = _together([r["eval"][name][i] for r in got[layout]],
                          LAYOUTS[layout][1])
        np.testing.assert_allclose(heads.numpy(), want, rtol=1e-5,
                                   atol=1e-5, err_msg=f"head {i}")
        np.testing.assert_allclose(single["eval"][name][i].numpy(), want,
                                   rtol=1e-5, atol=1e-5, err_msg=f"head {i}")
    cm = single["eval"][f"cm_{name}"]
    valid = sum(int((w.zoo_batch(s)[1] != 255).sum()) for s in (8, 9))
    assert int(cm.sum()) == valid
    for r in got[layout]:
        assert torch.equal(r["eval"][f"cm_{name}"], cm)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", w.CAS_MODELS)
def test_loss_and_gradients_match_the_single_process(runs, layout, name):
    got, single = runs[:2]
    want = single[f"grads_{name}"]
    assert int(want["halo_exchanges"]) == 0
    grads = _whole(got[layout], f"grads_{name}", "grads")
    for r in got[layout]:
        g = r[f"grads_{name}"]
        assert torch.equal(g["loss"], got[layout][0][f"grads_{name}"]["loss"])
        bars.check_loss_and_gradients({"loss": g["loss"], "grads": grads},
                                      want["loss"], want["grads"],
                                      head=HEADS[name],
                                      head_tol=OHEM_HEAD_GRAD_TOL)
        assert int(g["halo_exchanges"]) == CAS_HALO_EXCHANGES[name]
        assert int(g["k3"]) == 0
        _stats_match(g["stats"], want["stats"], 1e-5, 1e-6)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", w.CAS_MODELS)
def test_float64_gradients_match_the_single_process(runs, layout, name):
    """In float64 only the sums' order sets the bands apart: the tree
    and the statistics at 1e-10, the loss (a float32 CE) at 1e-6. Every
    gate's parameters are in the tree, so a band's partial mean counted
    once per band would show."""
    got, single = runs[:2]
    want = single[f"grads64_{name}"]
    keys = list(want["grads"])
    assert want["grads"][keys[0]].dtype == torch.float64
    gates = [k for k in keys if k.startswith(
        ("context.arm", "context.tail", "ffm.se", "ppm."))]
    assert gates
    grads = _whole(got[layout], f"grads64_{name}", "grads")
    assert bars.rel_tree(grads, want["grads"], keys) <= 1e-10
    assert bars.rel_tree(grads, want["grads"], gates) <= 1e-10
    for r in got[layout]:
        g = r[f"grads64_{name}"]
        np.testing.assert_allclose(float(g["loss"]), float(want["loss"]),
                                   rtol=1e-6)
        assert int(g["halo_exchanges"]) == CAS_HALO_EXCHANGES[name]
        _stats_match(g["stats"], want["stats"], 1e-10, 1e-12)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", w.CAS_MODELS)
def test_k3_route_on_bands_matches_the_single_process(runs, layout, name):
    """The three heads through K3's plain version on each band (three
    calls a forward, as in the single process, at x8, x8, x16 or x4, x8,
    x16), within the single process's bf16-to-float32 gap plus the
    float32 route's own gap on these bands."""
    got, single = runs[:2]
    want = single[f"grads_{name}_k3"]
    keys = list(want["grads"])
    yard = bars.rel_tree(want["grads"], single[f"grads_{name}"]["grads"],
                         keys)
    assert int(want["k3"]) == 3
    f32_gap = bars.rel_tree(_whole(got[layout], f"grads_{name}", "grads"),
                            single[f"grads_{name}"]["grads"], keys)
    grads = _whole(got[layout], f"grads_{name}_k3", "grads")
    assert bars.rel_tree(grads, want["grads"], keys) <= yard + f32_gap
    for r in got[layout]:
        g = r[f"grads_{name}_k3"]
        assert int(g["k3"]) == 3
        assert int(g["halo_exchanges"]) == CAS_HALO_EXCHANGES[name]
        np.testing.assert_allclose(float(g["loss"]), float(want["loss"]),
                                   rtol=BF16_LOSS_RTOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", w.CAS_MODELS)
def test_sgd_step_through_make_train_step(runs, layout, name):
    got, single = runs[:2]
    want = single[f"steps_{name}"]
    keys = [k for k in want["state1"] if not k.endswith("tracked")]
    state = _whole(got[layout], f"steps_{name}", "state1")
    for k in keys:
        np.testing.assert_allclose(state[k].numpy(), want["state1"][k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for r in got[layout]:
        s = r[f"steps_{name}"]
        assert torch.equal(s["losses"],
                           got[layout][0][f"steps_{name}"]["losses"])
        np.testing.assert_allclose(s["losses"].numpy(),
                                   want["losses"].numpy(), rtol=1e-5)


# --- the ops, on the bands of one tensor in this process ---

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("n", [2, 4])
def test_downsampling_resize_on_bands(n, k, dtype):
    """An integer x1/k of H and W (ICNet's input and sub2 at 1/2) on
    bands of k·4 rows, no halo: the unsharded rows bit for bit, and the
    input gradient (each input row is read by at most one output row with
    a weight of 1/2 or 1, so no sum's order can differ)."""
    x = _rng_tensor(60 + k, 2, 4 * k * n, 6 * k, 5, dtype=dtype)
    x.requires_grad_(True)
    size = (4 * n, 6)
    want = upsample.resize_bilinear(x, size)
    g = _rng_tensor(62, *want.shape, dtype=dtype)
    (want.float() * g.float()).sum().backward()
    dx_want, x.grad = x.grad, None
    got = Bands(n).run(lambda xb: upsample.resize_bilinear(
        xb, (xb.shape[1] // k, xb.shape[2] // k)), x)
    for s, y in enumerate(got):
        assert y.shape == (2, 4, 6, 5)
        (y.float() * g[:, 4 * s:4 * (s + 1)].float()).sum().backward()
    assert torch.equal(torch.cat(got, dim=1), want)
    assert torch.equal(x.grad, dx_want)


@pytest.mark.parametrize("h,oh,align_corners", [
    (5, 2, False),       # a band of 5 rows that x1/2 does not divide
    (6, 4, False),       # a ratio of 3/2
    (4, 6, False),       # a ratio of 2/3
    (8, 4, True),        # align_corners=True downsampling
    (4, 8, True),        # and upsampling
])
def test_band_resize_refusals(h, oh, align_corners):
    """Every resize of a band that is not an integer x k or x 1/k with
    align_corners=False raises, naming the band's sizes."""
    x = _rng_tensor(64, 1, 2 * h, 4, 3)
    with Bands(2).rank(0):
        with pytest.raises(NotImplementedError,
                           match=f"from {h} to {oh} rows"):
            upsample.resize_bilinear(x[:, :h], (oh, 4),
                                     align_corners=align_corners)
        with pytest.raises(NotImplementedError,
                           match=f"from {h} to {oh} rows"):
            upsample.resize_argmax(x[:, :h], (oh, 4),
                                   align_corners=align_corners)


@contextlib.contextmanager
def _patched(module, **attrs):
    saved = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


class SummedBands(Bands):
    """`Bands` whose sums over ranks are real: each sum (the band's part
    of a global mean, `spatial_sum`; BN's moments, `all_reduce_sum`, each
    band one rank of weight 1/n) returns the sum of every band's part as
    one autograd node, so its gradient reaches every band's part, as the
    all-reduce's backward sends it. `fn` runs on every band once for each
    sum and once more: pass p sums the p-th sum's parts from the bands
    of pass p, each of which read the sums before it from the passes
    before, and the last pass reads them all."""

    def _halo(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        # a 1x1 conv of a global mean (the gates) takes no halo
        return super()._halo(x, top, bottom) if top or bottom else x

    def run(self, fn, x: torch.Tensor) -> list:
        totals: list = []
        while True:
            parts, out = [], []
            for s in range(self.n):
                seen = [0]

                def summed(t, seen=seen):
                    i = seen[0]
                    seen[0] += 1
                    if i < len(totals):
                        return totals[i]
                    if i == len(totals):
                        parts.append(t)
                    return t

                band = self.take(x, s)
                with self.rank(s), _patched(
                        distributed, spatial_sum=summed,
                        all_reduce_sum=summed,
                        is_initialized=lambda: True,
                        world_size=lambda: self.n):
                    out.append(fn(band))
            if not parts:
                return out
            totals.append(sum(parts))


def _arm_and_ffm(name: str):
    """(module in train mode, float64, its global inputs): BiSeNet's ARM
    (a 3x3 conv-BN-ReLU gated by BN of a 1x1 conv of its global mean) or
    FFM (concat → 1x1 conv-BN-ReLU, gated by a squeeze-excite of its
    global mean), on 4 images each with its own offset, so that the
    gates' BNs normalise well-separated values."""
    gen = torch.Generator().manual_seed(6)
    rng = np.random.default_rng(7)
    offset = np.arange(4, dtype=np.float64)[:, None, None, None]
    if name == "arm":
        m = AttentionRefinement(8, 6, generator=gen)
        xs = [rng.normal(size=(4, 16, 5, 8)) + 0.5 * offset]
    else:
        m = FeatureFusionModule(12, 8, generator=gen)
        xs = [rng.normal(size=(4, 16, 5, c)) + 0.5 * offset for c in (5, 7)]
    return m.double().train(), [torch.from_numpy(a) for a in xs]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["arm", "ffm"])
def test_arm_and_ffm_gates_on_bands_float64(name, n):
    """ARM and FFM on n bands in float64: the unsharded output rows, the
    input gradients and every parameter's gradient (the bands' summed:
    `all_reduce_gradients`) at 1e-10, the gates' among them. The gate's
    global mean is the same on every band, and each band's cotangent of
    it is partial: the sum's backward adds them, once each."""
    m, xs = _arm_and_ffm(name)
    ref = copy.deepcopy(m)
    xs = [x.requires_grad_(True) for x in xs]
    want = ref(*xs)
    g = _rng_tensor(65, *want.shape).double()
    (want * g).sum().backward()
    dx_want = [x.grad for x in xs]
    for x in xs:
        x.grad = None
    if name == "arm":
        got = SummedBands(n).run(m, xs[0])
    else:
        # the FFM's convs are 1x1s: its inputs take no halo, and go as one
        split = [t.shape[-1] for t in xs]
        got = SummedBands(n).run(
            lambda xb: m(*torch.split(xb, split, dim=-1)),
            torch.cat(xs, dim=-1))
    per = want.shape[1] // n
    sum((y * g[:, s * per:(s + 1) * per]).sum()
        for s, y in enumerate(got)).backward()
    scale = float(want.detach().abs().max())
    torch.testing.assert_close(torch.cat(got, dim=1), want, rtol=0,
                               atol=1e-12 * scale)
    for xi, dxi in zip(xs, dx_want):
        torch.testing.assert_close(xi.grad, dxi, rtol=1e-10, atol=1e-12)
    gate = ("gate_", "se1", "se2")
    assert any(k.startswith(gate) for k, _ in m.named_parameters())
    for (k, p), (_, q) in zip(m.named_parameters(), ref.named_parameters()):
        assert bars.rel_tree({k: p.grad}, {k: q.grad}, [k]) <= 1e-10, k
