"""PyTorch port, spatial sharding of DeepLabV3 and UNet on the CPU.

In gloo ranks (`tests/torch_mp_worker.py`, suite "zoo:S"): four ranks of
one data row (`num_spatial=4`) and four as 2 data rows x 2 bands, each on
its band of its rows of the global batch:

- `halo` and `on_band` with halos smaller than a band, equal to it and
  longer (gathered from several bands, cut at the image's edges), forward
  and backward, against slicing the global tensor (float64, exact up to
  the order of a sum);
- the eval forward of DeepLabV3-ResNet18 and of UNet on both decoders,
  the bands put together, against the JAX package's forward of the same
  weights on a (data 2, spatial 4) mesh of 8 CPU devices, on the JAX
  spatial test's input at its 1e-5: at 4 bands ASPP's rate-18 halo
  spans every band and stops at the image's edges; DeepLabV3-ResNet50
  (the BottleneckBlock path) against this process's forward;
- `evaluate`'s matrix of DeepLab's 1/16 logits and UNet's against this
  process's.

In this process, on the bands of one tensor (`Bands`): the band-aware max
pool (−inf padding at the image's edges only), K4's band route through its
plain version (bit for bit with the unsharded rows), the transposed conv's
geometries, and the gate over the 13 zoo names. ENet, ERFNet and ESNet
on bands: `tests/test_torch_spatial_decoders.py`."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import torch_mp_worker as w
from test_torch_spatial import Bands, _rng_tensor
from torch_port_util import jax_zoo_model, randomize_bn
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.data.synthetic import synthetic_batch
from torch_semantic_segmentation_tpu.parallel import (
    batch_sharding, data_parallel_mesh, replicate)
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax
from torch_semantic_segmentation_tpu_torch.models import (
    available_models, check_spatial_model, get_model)
from torch_semantic_segmentation_tpu_torch.ops import pool
from torch_semantic_segmentation_tpu_torch.ops import upsample_concat as uc
from torch_semantic_segmentation_tpu_torch.ops.conv import ConvTranspose2d
from torch_semantic_segmentation_tpu_torch.parallel import distributed

torch.set_num_threads(2)

LAYOUTS = {"s4": (4, 1), "d2s2": (2, 2)}      # name: (spatial, data rows)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({layout: ranks}, this process's results, {model: the JAX package's
    logits on the (2, 4) mesh})."""
    out = str(tmp_path_factory.mktemp("spatial_zoo"))
    jax_models = {}
    for i, (key, name, kw) in enumerate(w.ZOO_EVAL):
        j = jax_zoo_model(name, w.C, seed=i, **{
            **(w.ZOO_UNET if name == "unet" else {}), **kw})
        randomize_bn(j, np.random.default_rng(10 + i))
        j.eval()
        torch.save(state_dict_from_jax(export_torch_state_dict(j)),
                   f"{out}/{key}.pt")
        jax_models[key] = j
    procs = {}
    for name, (spatial, _) in LAYOUTS.items():
        sub = f"{out}/{name}"
        os.makedirs(sub)
        for key, _, _ in w.ZOO_EVAL:
            shutil.copy(f"{out}/{key}.pt", sub)
        procs[name] = (w.launch(f"zoo:{spatial}", sub, world=4), sub)

    mesh = data_parallel_mesh(num_data=2, num_spatial=4)
    x = jnp.asarray(synthetic_batch(w.ZOO_N, w.ZOO_H, w.ZOO_W, w.C,
                                    seed=7)[0])
    xs = jax.device_put(x, batch_sharding(mesh, spatial_dim=1,
                                          input_extent=x.shape[1]))
    jax_run = {}
    for key, j in jax_models.items():
        gd, st = nnx.split(j)
        fwd = jax.jit(lambda st, x, gd=gd: nnx.merge(gd, st)(x))
        jax_run[key] = np.asarray(fwd(replicate(st, mesh), xs))
    single = w.case_zoo_eval(out)
    got = {name: w.collect(p, sub) for name, (p, sub) in procs.items()}
    return got, single, jax_run


def _together(parts: list, data: int) -> torch.Tensor:
    """The global tensor from the ranks' bands: rank d·S + s holds data
    row d's band s."""
    spatial = len(parts) // data
    return torch.cat([torch.cat(parts[d * spatial:(d + 1) * spatial], dim=1)
                      for d in range(data)])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_halo_of_any_length(runs, layout):
    """Each rank's band + halo is the global tensor's rows around its
    band, cut at the image's edges; its gradient, summed over every
    rank's halo, is the gradient of slicing the global tensor."""
    got, _, _ = runs
    spatial, data = LAYOUTS[layout]
    x = w.halo_input(spatial)
    per_d = x.shape[0] // data
    rows = x.shape[1] // spatial
    for i, case in enumerate(w.HALO_CASES):
        top, bottom = w.halo_rows_of(case, rows)
        xg = x.clone().requires_grad_(True)
        total = 0
        for r, res in enumerate(got[layout]):
            d, s = divmod(r, spatial)
            lo, hi = max(0, s * rows - top), min(x.shape[1],
                                                 (s + 1) * rows + bottom)
            want = xg[d * per_d:(d + 1) * per_d, lo:hi]
            y = res["halos"][f"halo{i}"]["y"]
            assert torch.equal(y, want.detach()), (case, r)
            total = total + (want * w.halo_cotangent(i, r, y.shape)).sum()
        total.backward()
        dx = _together([r["halos"][f"halo{i}"]["dx"] for r in got[layout]],
                       data)
        torch.testing.assert_close(dx, xg.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_on_band_of_any_halo(runs, layout):
    """A conv on band + halo through `on_band`, dilated past one band and
    past two, strided, gives the band's rows of the global conv, and the
    global input gradient."""
    got, _, _ = runs
    spatial, data = LAYOUTS[layout]
    x = w.halo_input(spatial).requires_grad_(True)
    rows = x.shape[1] // spatial
    per_d = x.shape[0] // data
    for i, (k, stride, dil) in enumerate(w.ON_BAND_CASES):
        fn = w.on_band_conv(i, k, stride, dil, rows)[0]
        want = fn(x)
        orow = rows // stride
        total = 0
        for r in range(len(got[layout])):
            d, s = divmod(r, spatial)
            part = want[d * per_d:(d + 1) * per_d, s * orow:(s + 1) * orow]
            y = got[layout][r]["halos"][f"on_band{i}"]["y"]
            torch.testing.assert_close(y, part.detach(), rtol=1e-12,
                                       atol=1e-12)
            total = total + (part * w.halo_cotangent(100 + i, r,
                                                     y.shape)).sum()
        total.backward()
        dx = _together([r["halos"][f"on_band{i}"]["dx"]
                        for r in got[layout]], data)
        torch.testing.assert_close(dx, x.grad, rtol=1e-12, atol=1e-12)
        x.grad = None


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("key", [k for k, _, _ in w.ZOO_EVAL])
def test_eval_forward_matches_jax_spatial_mesh(runs, layout, key):
    got, single, jax_run = runs
    logits = _together([r["eval"][key] for r in got[layout]],
                       LAYOUTS[layout][1])
    np.testing.assert_allclose(logits.numpy(), jax_run[key], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(single[key].numpy(), jax_run[key], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_resnet50_and_eval_matrices_match_the_single_process(runs, layout):
    got, single, _ = runs
    logits = _together([r["eval"]["deeplab50"] for r in got[layout]],
                       LAYOUTS[layout][1])
    scale = float(single["deeplab50"].abs().max())
    torch.testing.assert_close(logits, single["deeplab50"], rtol=1e-5,
                               atol=1e-5 * scale)
    valid = sum(int((w.zoo_batch(s)[1] != 255).sum()) for s in (8, 9))
    for key in ("deeplab", "unet_bilinear"):
        cm = single[f"cm_{key}"]
        assert int(cm.sum()) == valid
        for r in got[layout]:
            assert torch.equal(r["eval"][f"cm_{key}"], cm), key


# --- the ops, on the bands of one tensor in this process ---

@pytest.mark.parametrize("window,stride,padding", [(3, 2, 1), (2, 2, 0)])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("ties", [False, True])
def test_max_pool_on_bands(window, stride, padding, n, ties):
    """ResNet's stem pool (3×3/s2/p1, a 2-row top halo) and UNet's 2×2/s2
    (none) on bands: the global pool's rows bit for bit, and its input
    gradient (a tied window gives its gradient to the same first maximum;
    a row that two bands' windows read sums their parts in another order:
    1e-6).
    The values are negative, so a zero row in place of the −inf padding,
    or of a halo row, would show."""
    x = _rng_tensor(20, 2, 16 * n, 12, 3) - 10.0
    if ties:
        x = torch.round(x)
    x.requires_grad_(True)
    want = pool.max_pool2d(x, window, stride, padding)
    g = _rng_tensor(21, *want.shape)
    (want * g).sum().backward()
    dx_want, x.grad = x.grad, None
    got = Bands(n).run(lambda t: pool.max_pool2d(t, window, stride, padding),
                       x)
    per = want.shape[1] // n
    for s, y in enumerate(got):
        (y * g[:, s * per:(s + 1) * per]).sum().backward()
    assert torch.equal(torch.cat(got, dim=1), want)
    torch.testing.assert_close(x.grad, dx_want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
def test_k4_band_route_is_the_unsharded_rows(dtype, n):
    """K4 on a band (its plain version here): one halo row of low each
    side, output rows from 2·t, the band's skip: the unsharded result's
    rows bit for bit; the gradients of low (the adjoint of the cropped
    upsample, halo rows sent back) and of skip at 1e-6."""
    low = _rng_tensor(22, 2, 2 * n, 5, 4, dtype=dtype).requires_grad_(True)
    skip = _rng_tensor(23, 2, 4 * n, 10, 3, dtype=dtype).requires_grad_(True)
    want = uc.upsample2x_concat(low, skip)
    g = _rng_tensor(24, *want.shape, dtype=dtype)
    (want.float() * g.float()).sum().backward()
    dl_want, ds_want = low.grad, skip.grad
    low.grad = skip.grad = None
    bands = Bands(n)
    got = []
    for s in range(n):
        lb = bands.take(low, s)
        with bands.rank(s):
            y = uc.upsample2x_concat(lb, skip[:, 4 * s:4 * (s + 1)])
        (y.float() * g[:, 4 * s:4 * (s + 1)].float()).sum().backward()
        got.append(y)
    assert torch.equal(torch.cat(got, dim=1), want)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(low.grad.float(), dl_want.float(), rtol=0,
                               atol=tol * float(dl_want.float().abs().max()))
    assert torch.equal(skip.grad, ds_want)


def test_k4_rows_and_their_checks():
    """`upsample_concat_forward` from output row 2 of an upsample of 4 rows
    is rows 2..5 of the whole; rows past 2H raise."""
    low = _rng_tensor(25, 1, 4, 3, 2)
    skip = _rng_tensor(26, 1, 4, 6, 2)
    whole = uc.upsample_concat_forward(low, _rng_tensor(26, 1, 8, 6, 2))
    got = uc.upsample_concat_forward(low, skip, 2)
    assert torch.equal(got[..., :2], whole[:, 2:6, :, :2])
    assert torch.equal(got[..., 2:], skip)
    with pytest.raises(ValueError, match="2H, 2W"):
        uc.upsample_concat_forward(low, skip, 5)


def test_transposed_conv_on_bands():
    """UNet's 2×2/s2 transposed conv maps each band row to its own two
    rows, and the 3×3/s2/p1/op1 of ERFNet, ESNet and ENet takes one bottom
    halo row: the global result's rows. Any other geometry, here a 3×3/s2
    without padding, raises under spatial sharding, naming the two it
    takes."""
    x = _rng_tensor(27, 2, 8, 6, 4)
    up = ConvTranspose2d(4, 3, 2, stride=2,
                         generator=torch.Generator().manual_seed(0))
    want = up(x)
    got = Bands(4).run(up, x)
    torch.testing.assert_close(torch.cat(got, dim=1), want, rtol=0, atol=0)
    odd = ConvTranspose2d(4, 3, 3, stride=2, padding=1, output_padding=1,
                          generator=torch.Generator().manual_seed(0))
    want = odd(x)
    got = Bands(4).run(odd, x)
    torch.testing.assert_close(torch.cat(got, dim=1), want, rtol=1e-6,
                               atol=1e-6)
    other = ConvTranspose2d(4, 3, 3, stride=2,
                            generator=torch.Generator().manual_seed(0))
    other(x)
    with Bands(2).rank(0):
        with pytest.raises(NotImplementedError,
                           match="transposed conv.*3x3/s2 with padding 1"):
            other(x[:, :4])


SPATIAL_NAMES = ("fastscnn", "unet", "deeplabv3_resnet18",
                 "deeplabv3_resnet34", "deeplabv3_resnet50",
                 "deeplabv3_resnet101", "enet", "erfnet", "esnet",
                 "bisenet", "icnet")


@pytest.mark.parametrize("name", available_models())
def test_the_gate(monkeypatch, name):
    """Under spatial sharding FastSCNN, DeepLabV3 (every depth), UNet,
    ENet, ERFNet, ESNet, BiSeNet and ICNet are admitted by name and by
    module; any other zoo name (LEDNet, ContextNet) raises, naming the
    eight and the models still refused."""
    monkeypatch.setattr(distributed, "is_spatial", lambda: True)
    monkeypatch.setattr(distributed, "num_spatial", lambda: 2)
    if name in SPATIAL_NAMES:
        check_spatial_model(name)
        return
    refused = [n for n in available_models() if n not in SPATIAL_NAMES]
    assert refused == ["contextnet", "lednet"]
    with pytest.raises(NotImplementedError,
                       match=f"FastSCNN, DeepLabV3, UNet, ENet, ERFNet, "
                             f"ESNet, BiSeNet and ICNet; {name}.*still "
                             "refused: " + ", ".join(refused)):
        check_spatial_model(name)
    with pytest.raises(NotImplementedError):
        get_model(name, 5, device="cpu")


def test_the_gate_by_module(monkeypatch):
    unet = get_model("unet", 5, base_ch=4, device="cpu")
    admitted = [get_model(n, 5, device="cpu")
                for n in ("enet", "erfnet", "esnet")]
    cascades = [get_model(n, 5, depth=18, device="cpu")
                for n in ("bisenet", "icnet")]
    lednet = get_model("lednet", 5, device="cpu")
    contextnet = get_model("contextnet", 5, device="cpu")
    monkeypatch.setattr(distributed, "is_spatial", lambda: True)
    monkeypatch.setattr(distributed, "num_spatial", lambda: 2)
    check_spatial_model(unet)
    for m in admitted:
        check_spatial_model(m)
        assert m.max_stride == 8
    for m in cascades:
        check_spatial_model(m)
        assert m.max_stride == 32
    with pytest.raises(NotImplementedError, match="LEDNet"):
        check_spatial_model(lednet)
    with pytest.raises(NotImplementedError, match="ContextNet"):
        check_spatial_model(contextnet)
    assert unet.max_stride == 16
    assert get_model("deeplabv3_resnet18", 5, device="cpu",
                     output_stride=8).max_stride == 8
