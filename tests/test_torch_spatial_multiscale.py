"""PyTorch port, the multi-scale (+ flip) eval step on H bands, on the CPU.

In gloo ranks (`tests/torch_mp_worker.py`, suite "ms:S"): ENet (max
stride 8) at 128x64 on four ranks of one data row and on 2 data rows x 2
bands, BiSeNet-R18 on config 5's 1/8 main head at 256x64 on 2 x 2, each
rank on its band of its rows of one batch of 2 images, through
`make_multiscale_eval_step` (scales 0.5 .. 1.75, flip) and `evaluate`:

- in float64, the summed probabilities the step argmaxes, the bands put
  together, against this process's at 1e-10, and the matrices equal;
- in float32, the ids the step counted against the JAX package's
  multi-scale step on a (data 2, spatial 4) mesh of 8 CPU devices,
  counted by the JAX step (the port's ids as its labels) as
  `tests/test_torch_eval.py` counts them: at most 1e-3 of the pixels
  apart, and both matrices count every valid pixel once.

The JAX step rounds the scaled sizes from the global H, as the bands'
step does from h·S; every default scale of these sizes splits into
bands of a multiple of the model's stride.

In this process, on the bands of one tensor (`Bands` of
`tests/test_torch_spatial.py`): the general band resize at the step's
ratios scaled to test size (1024 → 768 rows as 32 → 24 a band, 160 →
1024 as 5 → 32), forward, on 2 and 4 bands, bit for bit with the
unsharded rows; and the ValueError of a scale that does not split
(BiSeNet at 128 rows on 4 bands: scale 0.5 gives 64 rows).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mp_worker as w
from test_torch_spatial import Bands, _rng_tensor
from torch_port_util import jax_zoo_model
from torch_semantic_segmentation_tpu import eval as jeval
from torch_semantic_segmentation_tpu import metrics as jmetrics
from torch_semantic_segmentation_tpu import train as jtrain
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict, import_torch_state_dict)
from torch_semantic_segmentation_tpu.parallel import (
    batch_sharding, data_parallel_mesh, label_sharding, replicate)
from torch_semantic_segmentation_tpu_torch import eval as teval
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax
from torch_semantic_segmentation_tpu_torch.eval import (
    make_multiscale_eval_step)
from torch_semantic_segmentation_tpu_torch.models import get_model
from torch_semantic_segmentation_tpu_torch.ops import upsample

torch.set_num_threads(2)

LAYOUTS = {"s4": (4, 1), "d2s2": (2, 2)}      # name: (spatial, data rows)
CASES = [(layout, key) for layout, (spatial, _) in LAYOUTS.items()
         for key, _, _, _ in w.ms_models(spatial)]
SCALES = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)


def calibrate_over_scales(t, x: np.ndarray, seed: int, head=None) -> None:
    """The port's model `t` with every BatchNorm's running statistics the
    mean of its batch statistics over one train-mode forward at each of
    SCALES, and random affine parameters; the classifier `head` (a conv)
    then takes out each class's mean logit over the scales. Statistics
    from one scale leave a random network's logits at the others tens of
    units apart by class, so that the summed softmaxes pick one class
    everywhere; these vary over the image. Leaves `t` in eval mode."""
    rng = np.random.default_rng(seed)
    bns = [m for m in t.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for m in bns:
            m.weight.copy_(torch.from_numpy(rng.uniform(
                0.5, 1.5, m.weight.shape).astype(np.float32)))
            m.bias.copy_(torch.from_numpy(rng.normal(
                0, 0.2, m.bias.shape).astype(np.float32)))
            m.momentum = None                 # the cumulative average
            m.num_batches_tracked.zero_()
        scaled = [upsample.resize_bilinear(torch.from_numpy(x), (
            _round_div(x.shape[1] * s), _round_div(x.shape[2] * s)))
            for s in SCALES]
        t.train()
        for xs in scaled:
            t(xs)
        for m in bns:
            m.momentum = 0.1
            m.num_batches_tracked.zero_()
        t.eval()
        if head is not None:
            head.bias -= torch.stack([
                teval._main_logits(t(xs)).mean(dim=(0, 1, 2))
                for xs in scaled]).mean(dim=0)


def _round_div(v: float) -> int:
    return max(int(round(v / 32)) * 32, 32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({layout: ranks}, this process's results, {key: (the JAX step,
    its replicated parameters and state on the (2, 4) mesh)})."""
    out = str(tmp_path_factory.mktemp("spatial_multiscale"))
    mesh = data_parallel_mesh(num_data=2, num_spatial=4)
    jax_steps = {}
    for i, (key, name, kw, h) in enumerate(w.MS_MODELS):
        j = jax_zoo_model(name, w.C, seed=40 + i, **kw)
        t = get_model(name, w.C, device="cpu", **kw)
        t.load_state_dict(state_dict_from_jax(export_torch_state_dict(j)))
        calibrate_over_scales(t, w.ms_batch(h)[0], 50 + i,
                              t.head.cls if key == "bisenet" else None)
        torch.save(t.state_dict(), f"{out}/{key}.pt")
        import_torch_state_dict(j, t.state_dict())
        j.eval()
        _, gd_eval, params, rest = jtrain.split_train_eval(j)
        jax_steps[key] = (jeval.make_multiscale_eval_step(
            gd_eval, num_classes=w.C), replicate(params, mesh),
            replicate(rest, mesh))
    procs = {}
    for layout, (spatial, _) in LAYOUTS.items():
        sub = f"{out}/{layout}"
        os.makedirs(sub)
        for key, _, _, _ in w.MS_MODELS:
            shutil.copy(f"{out}/{key}.pt", sub)
        procs[layout] = (w.launch(f"ms:{spatial}", sub, world=4), sub)
    single = w.suite_ms(out)
    got = {layout: w.collect(p, sub) for layout, (p, sub) in procs.items()}
    return got, single, (mesh, jax_steps)


def _together(parts: list, data: int) -> torch.Tensor:
    """The global tensor from the ranks' bands: rank d·S + s holds data
    row d's band s."""
    spatial = len(parts) // data
    return torch.cat([torch.cat(parts[d * spatial:(d + 1) * spatial], dim=1)
                      for d in range(data)])


def _valid(key: str) -> int:
    h = dict((k, h) for k, _, _, h in w.MS_MODELS)[key]
    return int((w.ms_batch(h)[1] != 255).sum())


@pytest.mark.parametrize("layout,key", CASES)
def test_float64_probabilities_and_matrix_match_the_single_process(
        runs, layout, key):
    got, single = runs[:2]
    want = single[f"{key}64"]
    assert want["probs"].dtype == torch.float64
    probs = _together([r[f"{key}64"]["probs"] for r in got[layout]],
                      LAYOUTS[layout][1])
    assert probs.shape == want["probs"].shape
    torch.testing.assert_close(probs, want["probs"], rtol=1e-10, atol=1e-10)
    assert int(want["cm"].sum()) == _valid(key)
    for r in got[layout]:
        assert torch.equal(r[f"{key}64"]["cm"], want["cm"])


@pytest.mark.parametrize("layout,key", CASES)
def test_float32_ids_match_jax_multiscale_step_on_the_mesh(runs, layout,
                                                           key):
    got, _, (mesh, jax_steps) = runs
    jstep, params, rest = jax_steps[key]
    h = dict((k, h) for k, _, _, h in w.MS_MODELS)[key]
    x, y = w.ms_batch(h)
    xs = jax.device_put(jnp.asarray(x), batch_sharding(
        mesh, spatial_dim=1, input_extent=h))
    ids = _together([r[key]["ids"] for r in got[layout]], LAYOUTS[layout][1])
    assert ids.shape == y.shape
    assert int((torch.bincount(ids.flatten()) > 0).sum()) >= 4

    def counted(labels):
        ys = jax.device_put(jnp.asarray(labels),
                            label_sharding(mesh, spatial=True))
        return np.asarray(jstep(params, rest, jmetrics.new_confusion_matrix(
            w.C), xs, ys))

    cm_j = counted(y)
    assert int(cm_j.sum()) == _valid(key)
    for r in got[layout]:
        assert int(r[key]["cm"].sum()) == _valid(key)
    # the JAX step's ids against the bands', counted by the JAX step
    agree = counted(ids.numpy().astype(np.int32))
    assert agree.sum() == ids.numel()
    assert 1.0 - np.trace(agree) / ids.numel() <= 1e-3


# --- the general band resize, on the bands of one tensor in this process ---

# (band rows, band output rows, W, output W): 1024 → 768 rows and 2048 →
# 1536 columns at 1/32 of their size, 160 → 1024 and 320 → 2048 at 1/32
# of theirs, and one that is no ratio of the step
GENERAL = [(32, 24, 64, 48), (5, 32, 10, 64), (6, 4, 9, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("h,oh,w_in,ow", GENERAL)
@pytest.mark.parametrize("n", [2, 4])
def test_general_band_resize_is_the_unsharded_rows(n, h, oh, w_in, ow,
                                                   dtype):
    """`resize_bilinear`, `resize_bilinear_nhcw` and `resize_argmax` of a
    band whose ratio is no integer x k or x 1/k: one halo row each side
    (none at the image's edges) and the global matrix's rows restricted
    to band + halo give the unsharded rows bit for bit."""
    x = _rng_tensor(70 + h, 2, h * n, w_in, 5, dtype=dtype, scale=2.0)
    for fn in (upsample.resize_bilinear, upsample.resize_bilinear_nhcw,
               upsample.resize_argmax):
        want = fn(x, (oh * n, ow))
        got = Bands(n).run(lambda xb, fn=fn: fn(xb, (oh, ow)), x)
        for y in got:
            assert y.shape[1] == oh
        assert torch.equal(torch.cat(got, dim=1), want), fn.__name__


@pytest.mark.parametrize("h,oh,w_in,ow", GENERAL)
@pytest.mark.parametrize("nhcw", [False, True])
def test_tap_pass_backward_is_the_matrix_product(h, oh, w_in, ow, nhcw):
    """A resize whose passes run as two taps (no integer ratio, as the
    PPM's bins 3 and 6 and the multi-scale step's) has the gradient of
    the dense product with the interpolation matrices in float64: its
    backward is that product (index_select's own would add by atomics
    on the card), also for the device tensors the step made under
    inference mode."""
    x = _rng_tensor(90 + h, 2, h, w_in, 5, dtype=torch.float64)
    fn = (upsample.resize_bilinear_nhcw if nhcw
          else upsample.resize_bilinear)
    with torch.inference_mode():
        fn(x, (oh, ow))                  # the passes' tensors made here
    mh, mw = (torch.from_numpy(upsample._interp_matrix(a, b, False)).double()
              for a, b in ((h, oh), (w_in, ow)))
    xs = [x.clone().requires_grad_() for _ in range(2)]
    y = fn(xs[0], (oh, ow))
    ref = torch.einsum("nhwc,oh,kw->nokc", xs[1], mh, mw)
    if nhcw:
        ref = ref.permute(0, 1, 3, 2)
    g = _rng_tensor(7, *y.shape, dtype=torch.float64)
    got, want = (torch.autograd.grad(t, s, g)[0] for t, s in zip((y, ref), xs))
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_a_scale_that_does_not_split_raises():
    """BiSeNet (max_stride 32) on 4 bands of a 128-row image: scale 0.5
    gives 64 rows, 2 rows at 1/32 for 4 bands, a degenerate split by the
    JAX package's guard (`check_spatial_extent`), so the step raises
    naming the scale and the sizes, before any forward, and pads
    nothing. Scales of unequal bands run
    (`tests/test_torch_spatial_uneven.py`)."""
    m = get_model("bisenet", w.C, depth=18, upsample_logits=False,
                  device="cpu")
    step = make_multiscale_eval_step(m, num_classes=w.C, device="cpu")
    x = torch.zeros(1, 128, 64, 3)
    with Bands(4).rank(1):
        with pytest.raises(ValueError, match="scale 0.5: degenerate "
                           "spatial sharding: input H=64 reaches H=2 at "
                           "stride 32"):
            step(torch.zeros(w.C, w.C, dtype=torch.int64), x[:, 32:64],
                 torch.zeros(1, 32, 64, dtype=torch.int64))
