"""PyTorch port, spatial sharding of ENet, ERFNet and ESNet on the CPU.

In gloo ranks (`tests/torch_mp_worker.py`, suite "dec:S"): four ranks of
one data row (`num_spatial=4`, bands of 32 rows: 4 rows at 1/8, so
ERFNet's dilation-16 halo reaches past every band and stops at the
image's edges, and ESNet's rate-9 halo spans three bands) and four as 2
data rows x 2 bands, each on its band of its rows of the global batch:

- the eval forward of each model, the bands put together, against the
  JAX package's forward of the same weights on a (data 2, spatial 4)
  mesh of 8 CPU devices, on the JAX spatial test's input at its 1e-5
  (the JAX package's packed ENet and ERFNet routes stay off, as in eval
  mode off the TPU); `evaluate`'s matrix against this process's;
- one train-mode forward and backward of each (from seed 0, dropout on:
  the bands draw the single process's masks; ENet with class weights)
  against this process on the global batch of 4x128x64, in float32: the
  loss at `spatial_bars.LOSS_RTOL`, the summed gradient over the tree at
  `GRAD_TREE_TOL` and over the output conv at `HEAD_GRAD_TOL`, the BN
  statistics at rtol 1e-5, atol 1e-6, and the halo exchanges; and in
  float64, the gradient and the statistics at 1e-10;
- one SGD step through `make_train_step` of ENet and ERFNet: the loss at
  1e-5 and the state after it at 1e-4, as the zoo's steps are held.

The float32 gradients of the bands read 6.3e-3 to 7.0e-3 (ENet),
2.4e-2 to 3.2e-2 (ERFNet) and 2.6e-2 to 2.8e-2 (ESNet) from the single
process's by relative L2 over the tree, under `GRAD_TREE_TOL`, while the
single process at 1 and at 2 threads agrees to 1e-6: the sums of the
bands' BN moments in another order move values that lie within float32
rounding of a ReLU's zero or of a near-tied max-pool window, which then
route their gradient elsewhere. So the same forward and backward runs
in float64 too (the loss's CE in float32, as always): there the bands
read at most 3.4e-13 over the tree and 3.8e-12 in the BN statistics,
held at 1e-10. A second float32 SGD step reads ERFNet's loss 4.7e-5
from the single process's, so the step is held once.

In this process, on the bands of one tensor (`Bands` of
`tests/test_torch_spatial.py`): the 3x3/s2/p1/op1 transposed conv, every
raw conv geometry of the three models, and ENet's pool with indices and
its unpool, against the unsharded rows, forward and backward."""

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
from torch_semantic_segmentation_tpu_torch.ops import pool
from torch_semantic_segmentation_tpu_torch.ops.conv import (
    ConvTranspose2d, make_conv)

torch.set_num_threads(2)

LAYOUTS = {"s4": (4, 1), "d2s2": (2, 2)}      # name: (spatial, data rows)
HEADS = {"enet": ("fullconv.",), "erfnet": ("output_conv.",),
         "esnet": ("output_conv.",)}
# a train step's halo exchanges, forward and backward (the image needs no
# gradient, so the first conv's halo makes no backward exchange): ENet
# 1 + 2 x 28 (26 bottlenecks' kh > 1 convs, the two transposed convs),
# ERFNet 1 + 2 x 38 (two downsamplers, 16 NonBottleneck1d's two 3x1 convs
# each, two upsamplers), ESNet 1 + 2 x 34 (two downsamplers, 7 FCUs' two
# Kx1 convs, 3 PFCUs' four 3x1 convs, two upsamplers)
DEC_HALO_EXCHANGES = {"enet": 57, "erfnet": 77, "esnet": 69}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({layout: ranks}, this process's results, {model: the JAX package's
    logits on the (2, 4) mesh})."""
    out = str(tmp_path_factory.mktemp("spatial_decoders"))
    jax_models = {}
    for i, name in enumerate(w.DEC_MODELS):
        j = jax_zoo_model(name, w.C, seed=20 + i)
        randomize_bn(j, np.random.default_rng(30 + i))
        j.eval()
        torch.save(state_dict_from_jax(export_torch_state_dict(j)),
                   f"{out}/{name}.pt")
        jax_models[name] = j
    procs = {}
    for layout, (spatial, _) in LAYOUTS.items():
        sub = f"{out}/{layout}"
        os.makedirs(sub)
        for name in w.DEC_MODELS:
            shutil.copy(f"{out}/{name}.pt", sub)
        procs[layout] = (w.launch(f"dec:{spatial}", sub, world=4), sub)

    mesh = data_parallel_mesh(num_data=2, num_spatial=4)
    x = jnp.asarray(synthetic_batch(w.ZOO_N, w.ZOO_H, w.ZOO_W, w.C,
                                    seed=7)[0])
    xs = jax.device_put(x, batch_sharding(mesh, spatial_dim=1,
                                          input_extent=x.shape[1]))
    jax_run = {}
    for name, j in jax_models.items():
        gd, st = nnx.split(j)
        fwd = jax.jit(lambda st, x, gd=gd: nnx.merge(gd, st)(x))
        jax_run[name] = np.asarray(fwd(replicate(st, mesh), xs))
    single = w.suite_dec(out)
    got = {layout: w.collect(p, sub) for layout, (p, sub) in procs.items()}
    return got, single, jax_run


def _together(parts: list, data: int) -> torch.Tensor:
    """The global tensor from the ranks' bands: rank d·S + s holds data
    row d's band s."""
    spatial = len(parts) // data
    return torch.cat([torch.cat(parts[d * spatial:(d + 1) * spatial], dim=1)
                      for d in range(data)])


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", w.DEC_MODELS)
def test_eval_forward_matches_jax_spatial_mesh(runs, layout, name):
    got, single, jax_run = runs
    logits = _together([r["eval"][name] for r in got[layout]],
                       LAYOUTS[layout][1])
    np.testing.assert_allclose(logits.numpy(), jax_run[name], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(single["eval"][name].numpy(), jax_run[name],
                               rtol=1e-5, atol=1e-5)
    cm = single["eval"][f"cm_{name}"]
    valid = sum(int((w.zoo_batch(s)[1] != 255).sum()) for s in (8, 9))
    assert int(cm.sum()) == valid
    for r in got[layout]:
        assert torch.equal(r["eval"][f"cm_{name}"], cm)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", w.DEC_MODELS)
def test_loss_and_gradients_match_the_single_process(runs, layout, name):
    got, single = runs[:2]
    want = single[f"grads_{name}"]
    assert int(want["halo_exchanges"]) == 0
    for r in got[layout]:
        g = r[f"grads_{name}"]
        assert torch.equal(g["loss"], got[layout][0][f"grads_{name}"]["loss"])
        bars.check_loss_and_gradients(g, want["loss"], want["grads"],
                                      head=HEADS[name])
        assert int(g["halo_exchanges"]) == DEC_HALO_EXCHANGES[name]
        for k, v in want["stats"].items():
            np.testing.assert_allclose(g["stats"][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", w.DEC_MODELS)
def test_float64_gradients_match_the_single_process(runs, layout, name):
    """In float64 only the sums' order sets the bands apart: the tree
    and the statistics at 1e-10, the loss (a float32 CE) at 1e-6."""
    got, single = runs[:2]
    want = single[f"grads64_{name}"]
    keys = list(want["grads"])
    assert want["grads"][keys[0]].dtype == torch.float64
    for r in got[layout]:
        g = r[f"grads64_{name}"]
        np.testing.assert_allclose(float(g["loss"]), float(want["loss"]),
                                   rtol=1e-6)
        assert bars.rel_tree(g["grads"], want["grads"], keys) <= 1e-10
        assert int(g["halo_exchanges"]) == DEC_HALO_EXCHANGES[name]
        for k, v in want["stats"].items():
            np.testing.assert_allclose(g["stats"][k].numpy(), v.numpy(),
                                       rtol=1e-10, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", w.DEC_STEP_MODELS)
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
        for k in keys:
            np.testing.assert_allclose(s["state1"][k].numpy(),
                                       want["state1"][k].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


# --- the ops, on the bands of one tensor in this process ---

def _bands_match(fn, x: torch.Tensor, n: int, seed: int, tol: float):
    """fn on each of n bands of x against fn(x): the output rows and the
    gradient of x, each at `tol` times its largest magnitude."""
    x = x.detach().requires_grad_(True)
    want = fn(x)
    g = _rng_tensor(seed, *want.shape, dtype=want.dtype)
    (want.float() * g.float()).sum().backward()
    dx_want, x.grad = x.grad, None
    got = Bands(n).run(fn, x)
    per = want.shape[1] // n
    for s, y in enumerate(got):
        (y.float() * g[:, s * per:(s + 1) * per].float()).sum().backward()
    y = torch.cat(got, dim=1)
    scale = float(want.detach().float().abs().max())
    torch.testing.assert_close(y.float(), want.float(), rtol=0,
                               atol=tol * scale)
    torch.testing.assert_close(
        x.grad.float(), dx_want.float(), rtol=0,
        atol=tol * float(dx_want.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
def test_transposed_conv_3x3_s2_on_bands(dtype, n):
    """ENet's and ERFNet's 3x3/s2/p1/op1 transposed conv on band + one
    bottom halo row: the unsharded result's rows, and the input gradient,
    a halo row's part sent back to its band (float32 1e-6; bf16 1e-2, a
    rounding step, where a sum in another order may round the other way).
    At the image's bottom no row arrives and the output padding's row is
    the unsharded one."""
    up = ConvTranspose2d(4, 3, 3, stride=2, padding=1, output_padding=1,
                         generator=torch.Generator().manual_seed(1))
    x = _rng_tensor(40, 2, 4 * n, 6, 4, dtype=dtype)
    _bands_match(up, x, n, 41, 1e-6 if dtype == torch.float32 else 1e-2)


RAW_CONVS = [
    # (kernel, stride, padding, dilation): the models' raw convs
    ((3, 3), 2, (1, 1), 1),          # ENet's initial, the downsamplers
    ((3, 1), 1, (1, 0), 1),          # NonBottleneck1d, FCU(3), PFCU stem
    ((5, 1), 1, (2, 0), 1),          # FCU(5)
    *[((3, 1), 1, (d, 0), (d, 1)) for d in (2, 4, 5, 8, 9, 16)],
    ((1, 3), 1, (0, 1), 1),
    ((1, 5), 1, (0, 2), 1),
    ((1, 3), 1, (0, 16), (1, 16)),
]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kernel,stride,padding,dilation", RAW_CONVS)
def test_raw_conv_on_bands(kernel, stride, padding, dilation, n):
    """A raw `make_conv` (not inside a `ConvBNAct`) takes the halo of its
    geometry on a band: the unsharded rows at 1e-6, and the input
    gradient. On 4 bands of 8 rows the dilation-9 and -16 halos reach
    past the next band, and stop at the image's edges."""
    conv = make_conv(4, 3, kernel, stride=stride, padding=padding,
                     dilation=dilation,
                     generator=torch.Generator().manual_seed(2))
    _bands_match(conv, _rng_tensor(42, 2, 32, 10, 4), n, 43, 1e-6)


def test_conv_off_the_band_grid_raises():
    """A stride-2 conv on a band of odd rows has no rows of the global
    result to give: it raises, and pads nothing."""
    conv = make_conv(4, 3, 3, stride=2, padding=1,
                     generator=torch.Generator().manual_seed(3))
    x = _rng_tensor(48, 1, 10, 4, 4)
    with Bands(2).rank(0):
        with pytest.raises(ValueError, match="stride-2 grid"):
            conv(x[:, :5])


@pytest.mark.parametrize("n", [2, 4])
def test_pool_with_indices_and_unpool_on_bands(n):
    """ENet's 2x2 pool with indices and its unpool on bands of even rows,
    with tied windows: the unsharded values, indices and unpooled rows bit
    for bit, and the gradients (a tied window splits its gradient equally
    among its maxima, on the band as on the whole)."""
    x = torch.round(_rng_tensor(44, 2, 8 * n, 6, 3)).requires_grad_(True)
    skip = _rng_tensor(45, 2, 4 * n, 3, 3).requires_grad_(True)

    def fn(t, s):
        y, idx = pool.max_pool2x2_with_indices(t)
        return y, idx, pool.max_unpool2x2(s, idx)

    want = fn(x, skip)
    g = [_rng_tensor(46, *want[0].shape), _rng_tensor(47, *want[2].shape)]
    ((want[0] * g[0]).sum() + (want[2] * g[1]).sum()).backward()
    dx_want, ds_want = x.grad, skip.grad
    x.grad = skip.grad = None
    bands = Bands(n)
    got = []
    for s in range(n):
        xb = bands.take(x, s)
        with bands.rank(s):
            y, idx, un = fn(xb, skip[:, 4 * s:4 * (s + 1)])
        ((y * g[0][:, 4 * s:4 * (s + 1)]).sum()
         + (un * g[1][:, 8 * s:8 * (s + 1)]).sum()).backward()
        got.append((y, idx, un))
    windows = x.detach().reshape(2, 4 * n, 2, 3, 2, 3).permute(
        0, 1, 3, 5, 2, 4).reshape(-1, 4)
    tied = (windows == windows.amax(dim=1, keepdim=True)).sum(dim=1) > 1
    assert int(tied.sum()) > 0
    for i in range(3):
        assert torch.equal(torch.cat([p[i] for p in got], dim=1), want[i])
    torch.testing.assert_close(x.grad, dx_want, rtol=0, atol=0)
    torch.testing.assert_close(skip.grad, ds_want, rtol=0, atol=0)
