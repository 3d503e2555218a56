"""PyTorch port, the bias-free depthwise 3×3 (K6) on the CPU, where its
wrappers run the plain versions:

- against the JAX package's Pallas kernel in interpret mode
  (`pallas_dw.depthwise_conv3x3(..., interpret=True)`) at the `FAST_CASES`
  of `test_pallas_dw.py`, bf16 x and the float32 kernel the routed path
  passes: the output and dx within one bf16 step of their scale (2^-8:
  float32 sums in another order may round to the other neighbour), dk at
  a relative L2 error of 1e-5 (float32 sums over every pixel);
- a float32 case against `depthwise_conv3x3_reference` (lax) and its
  autodiff at 1e-5;
- `LearningToDownsample` in train mode, bf16, with both packages routing
  the stride-2 depthwise convs (the JAX package's opt-in switch, its pixel
  floor and the packed LDS set as `test_torch_mbconv.py` sets its own),
  against the JAX module: output, dx and running means at the bars of
  `test_torch_mbconv.py`, each parameter's gradient at its bar for a
  noisy one (4e-2): three train-mode BNs in bf16 deep, the two packages'
  gradients read up to 2.1e-2 apart with neither routing and 2.7e-2 with
  both, while a port that kept the bf16-rounded kernel of the unrouted
  conv reads 8.6e-2 to 0.27 apart from the routed JAX module on every
  gradient (a probe on this file's inputs);
- the routing predicate's truth table;
- the plain forward and the plain stride-2 dx pinned bit for bit to the
  Hopper kernel's order of products and sums (a numpy float32 loop);
- the stride-1 backward's tile schedule emulated in numpy
  (`emulate_s1_backward`): dx bit for bit, the blocks' dk rows in the
  reduction's fixed order at 1e-5;
- the variants of `scripts/torch_dw_bwd_probe.py`, each patching only
  inside the kernel it names.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.models.fastscnn import (
    LearningToDownsample as JLearningToDownsample)
from torch_semantic_segmentation_tpu.ops import pallas_dw
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax
from torch_semantic_segmentation_tpu_torch.models.fastscnn import (
    LearningToDownsample)
from torch_semantic_segmentation_tpu_torch.ops import conv as tconv
from torch_semantic_segmentation_tpu_torch.ops import depthwise

from tests.test_torch_resize_ce_map_bwd import check_variant
from tests.torch_port_util import randomize_bn

torch.set_num_threads(2)

FAST_CASES = [((2, 16, 32, 32), 2), ((1, 8, 64, 48), 1)]


def _make(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=(3, 3, shape[-1])).astype(np.float32)
    return x, k


def _out_shape(shape, stride):
    n, h, w, c = shape
    return (n, (h - 1) // stride + 1, (w - 1) // stride + 1, c)


def _jax_fwd_grads(fn, x, k, ct, dtype):
    def f(x, k):
        return jnp.sum(fn(x, k).astype(jnp.float32) * ct)
    args = (jnp.asarray(x, dtype), jnp.asarray(k))
    y = np.asarray(fn(*args), np.float32)
    gx, gk = jax.grad(f, argnums=(0, 1))(*args)
    return y, np.asarray(gx, np.float32), np.asarray(gk, np.float32)


def _port_fwd_grads(x, k, stride, ct, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    y = depthwise.depthwise_conv3x3(xt, kt, stride)
    assert y.dtype == dtype
    (y.float() * torch.from_numpy(ct)).sum().backward()
    assert xt.grad.dtype == dtype and kt.grad.dtype == torch.float32
    return (y.detach().float().numpy(), xt.grad.float().numpy(),
            kt.grad.numpy())


def _rel(got, want):
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-9)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("shape,stride", FAST_CASES)
def test_depthwise_matches_jax_kernel(shape, stride):
    x, k = _make(shape)
    ct = np.cos(np.arange(np.prod(_out_shape(shape, stride)),
                          dtype=np.float32)).reshape(_out_shape(shape, stride))
    want = _jax_fwd_grads(
        lambda a, b: pallas_dw.depthwise_conv3x3(a, b, stride=stride,
                                                 interpret=True),
        x, k, ct, jnp.bfloat16)
    got = _port_fwd_grads(x, k, stride, ct, torch.bfloat16)
    for name, g, r in zip(("y", "dx", "dk"), got, want):
        assert g.shape == r.shape, name
    assert _rel(got[0], want[0]) <= 2.0 ** -8
    assert _rel(got[1], want[1]) <= 2.0 ** -8
    assert _rel_l2(got[2], want[2]) <= 1e-5


@pytest.mark.parametrize("stride", [1, 2])
def test_float32_matches_lax_reference(stride):
    shape = (2, 9, 14, 20)                  # odd H, C off 8
    x, k = _make(shape, seed=1)
    oshape = _out_shape(shape, stride)
    ct = np.random.default_rng(2).normal(size=oshape).astype(np.float32)
    want = _jax_fwd_grads(
        lambda a, b: pallas_dw.depthwise_conv3x3_reference(a, b,
                                                           stride=stride),
        x, k, ct, jnp.float32)
    got = _port_fwd_grads(x, k, stride, ct, torch.float32)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


def test_plain_backward_is_the_transpose_of_the_forward():
    """<g, conv(x)> = <dx(g), x> = <dk, k> at stride 2 with odd sizes, in
    float64 where the forward and both halves of the backward sum
    exactly alike."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 7, 9, 5)))
    k = torch.from_numpy(rng.normal(size=(3, 3, 5)))
    g = torch.from_numpy(rng.normal(size=(1, 4, 5, 5)))
    y = depthwise.depthwise3x3_reference(x, k, 2).double()
    dx, dk = depthwise.depthwise3x3_reference_backward(x, k, g, 2)
    lhs = float((g * y).sum())
    assert abs(lhs - float((dx.double() * x).sum())) < 1e-5
    assert abs(lhs - float((dk.double() * k).sum())) < 1e-5


def _bf16_round(a):
    """float32 → the nearest bf16 (ties to even), as float32: the bits of
    the output cast, written out in numpy."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


# (C, stride): the LDS's widths, GFE stage1[0]'s and a ragged one
PINNED_CASES = [(c, s) for c in (32, 48, 384, 20) for s in (1, 2)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("c,stride", PINNED_CASES)
def test_plain_forward_is_the_kernels_sum_bit_for_bit(c, stride, dtype):
    """`depthwise3x3_reference` against a numpy float32 loop in the Hopper
    kernel's order: taps row outer, column inner, each product and each sum
    rounded to float32 on its own (no fused multiply-add), the zero padding's
    products included, one rounding to x's type at the end. The card's test
    holds the kernel to the plain version with `torch.equal`; this pins the
    plain version to that order."""
    dtype = getattr(torch, dtype)
    rng = np.random.default_rng(c + stride)
    xt = torch.from_numpy(rng.normal(size=(2, 9, 11, c)).astype(
        np.float32)).to(dtype)
    k = rng.normal(size=(3, 3, c)).astype(np.float32) * 0.5
    got = depthwise.depthwise3x3_reference(xt, torch.from_numpy(k), stride)
    x = xt.float().numpy()
    ho, wo = (9 - 1) // stride + 1, (11 - 1) // stride + 1
    xp = np.zeros((2, 11, 13, c), np.float32)
    xp[:, 1:10, 1:12] = x
    acc = np.zeros((2, ho, wo, c), np.float32)
    for dh in range(3):
        for dw in range(3):
            win = xp[:, dh:dh + stride * (ho - 1) + 1:stride,
                     dw:dw + stride * (wo - 1) + 1:stride]
            prod = np.multiply(win, k[dh, dw], dtype=np.float32)
            acc = np.add(acc, prod, dtype=np.float32)
    want = _bf16_round(acc) if dtype == torch.bfloat16 else acc
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("c", [c for c, s in PINNED_CASES if s == 2])
def test_plain_stride2_dx_is_the_kernels_sum_bit_for_bit(c, dtype):
    """The stride-2 dx of `depthwise3x3_reference_backward` against a numpy
    float32 loop in the Hopper kernel's order: each input pixel sums the
    taps (dh, dw) whose output pixel lies in the image, dh outer and dw
    inner, from 0, each product and each sum rounded to float32 on its own,
    one rounding to x's type at the end. Even H and odd W, so that taps fall
    past the image at both ends. The card's test holds the kernel to the
    plain version with `torch.equal`; this pins the plain version to that
    order."""
    dtype = getattr(torch, dtype)
    n, h, w = 2, 10, 11
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    rng = np.random.default_rng(c)
    xt = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(
        np.float32)).to(dtype)
    gt = torch.from_numpy(rng.normal(size=(n, ho, wo, c)).astype(
        np.float32)).to(dtype)
    k = rng.normal(size=(3, 3, c)).astype(np.float32) * 0.5
    got, _ = depthwise.depthwise3x3_reference_backward(
        xt, torch.from_numpy(k), gt, 2)
    g = gt.float().numpy()
    acc = np.zeros((n, h, w, c), np.float32)
    for dh in range(3):
        for dw in range(3):
            # input row r = 2 i + dh - 1 of output row i, inside the image
            i = np.array([i for i in range(ho) if 0 <= 2 * i + dh - 1 < h])
            j = np.array([j for j in range(wo) if 0 <= 2 * j + dw - 1 < w])
            r, q = np.ix_(2 * i + dh - 1, 2 * j + dw - 1)
            prod = np.multiply(g[:, i][:, :, j], k[dh, dw], dtype=np.float32)
            acc[:, r, q] = np.add(acc[:, r, q], prod, dtype=np.float32)
    want = _bf16_round(acc) if dtype == torch.bfloat16 else acc
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


RUN1B = 4   # `csrc/depthwise.cu`: pixels a unit of the stride-1 backward


def _fma32(a, b, c):
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_s1_backward(x, k, dy, th, segs, blocks, lanes, run=RUN1B):
    """`dw_bwd_s1_kernel<T, run>` and `dw_dk_reduce_kernel` in numpy
    float32, tile by tile: tiles of th x segs * run pixels over all
    channels (run RUN1B, or 1 where no such tile fits), x and dy
    staged from row i0-1 and column j0-1 with zeros outside the image;
    block b walks tiles b, b + blocks, ...; lane l of a block takes units
    l, l + lanes, ... of each tile (row fastest), a unit a run of `run`
    pixels along W. Each unit walks the staged rows a = 0..2 and columns
    col = 0..run+1: dx of its pixel j adds dy (a, col) times the flipped
    tap k (2-a, 2-col+j), each product and sum rounded; dk (a, col-j) adds
    x (a, col) times pixel j's dy by a fused multiply-add. Then each
    block's lanes are summed in the kernel's tree and the blocks' rows by
    the reduction's fixed order. Returns (dx float32, per-block dk (blocks,
    9, C), dk (3, 3, C))."""
    n, h, w, c = x.shape
    tw = segs * run
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    hp, wp = tiles_y * th + 2, tiles_x * tw + 2
    xp = np.zeros((n, hp, wp, c), np.float32)
    dp = np.zeros((n, hp, wp, c), np.float32)
    xp[:, 1:h + 1, 1:w + 1] = x
    dp[:, 1:h + 1, 1:w + 1] = dy
    dx = np.full((n, h, w, c), np.nan, np.float32)
    dk = np.zeros((blocks, lanes, 9, c), np.float32)
    units = th * segs
    tiles = n * tiles_y * tiles_x
    for tile in range(tiles):
        b = tile % blocks
        img, ty, tx = (tile // (tiles_x * tiles_y), tile // tiles_x % tiles_y,
                       tile % tiles_x)
        xs = xp[img, ty * th:ty * th + th + 2, tx * tw:tx * tw + tw + 2]
        ds = dp[img, ty * th:ty * th + th + 2, tx * tw:tx * tw + tw + 2]
        for u in range(units):
            tr, sg = u % th, u // th
            oy, ox = ty * th + tr, tx * tw + sg * run
            if oy >= h or ox >= w:
                continue
            lane = u % lanes
            c0 = sg * run
            dc = ds[tr + 1, c0 + 1:c0 + 1 + run]
            acc = np.zeros((run, c), np.float32)
            for a in range(3):
                for col in range(run + 2):
                    xv, dv = xs[tr + a, c0 + col], ds[tr + a, c0 + col]
                    for j in range(run):
                        d = col - j
                        if 0 <= d <= 2:
                            t = 3 * a + d
                            dk[b, lane, t] = _fma32(xv, dc[j], dk[b, lane, t])
                            acc[j] = np.add(acc[j], np.multiply(
                                dv, k[2 - a, 2 - d], dtype=np.float32),
                                dtype=np.float32)
            m = min(run, w - ox)
            dx[img, oy, ox:ox + m] = acc[:m]
    top = 1
    while top < lanes:
        top *= 2
    s = top // 2
    while s:
        for lane in range(s):
            if lane + s < lanes:
                dk[:, lane] = np.add(dk[:, lane], dk[:, lane + s],
                                     dtype=np.float32)
        s //= 2
    rows = dk[:, 0]                                   # (blocks, 9, c)
    part = np.zeros((8, 9, c), np.float32)
    for r in range(blocks):
        part[r % 8] = np.add(part[r % 8], rows[r], dtype=np.float32)
    total = np.zeros((9, c), np.float32)
    for r in range(8):
        total = np.add(total, part[r], dtype=np.float32)
    return dx, rows, total.reshape(3, 3, c)


# (n, h, w, c, th, segs, blocks, lanes, run): odd H and W, tiles that
# straddle the bottom and the right edge (and, with one row or unit, every
# edge at once), several blocks and lanes; runs of one pixel as the wide
# float32 plans take them
S1_SCHEDULES = [(2, 9, 13, 3, 4, 2, 3, 5, 4), (1, 7, 11, 20, 3, 1, 4, 2, 4),
                (2, 5, 9, 384, 2, 1, 5, 1, 4), (1, 3, 5, 20, 4, 2, 1, 3, 4),
                (1, 1, 1, 3, 1, 1, 2, 1, 4), (1, 5, 7, 20, 2, 3, 3, 2, 1)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,h,w,c,th,segs,blocks,lanes,run", S1_SCHEDULES)
def test_stride1_backward_schedule_against_plain_version(
        n, h, w, c, th, segs, blocks, lanes, run, dtype):
    """The stride-1 backward's tile schedule, emulated in numpy: dx equal to
    `depthwise3x3_reference_backward` at stride 1 bit for bit (the card's
    test holds the kernel to the plain version with `torch.equal`; this
    holds the schedule's staging, halos and order of products), and the
    blocks' dk rows summed in the reduction's fixed order within a
    relative L2 error of 1e-5 of the plain dk, as every dk is held."""
    dtype = getattr(torch, dtype)
    rng = np.random.default_rng(c + h)
    xt = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(
        np.float32)).to(dtype)
    gt = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(
        np.float32)).to(dtype)
    k = rng.normal(size=(3, 3, c)).astype(np.float32) * 0.5
    want_dx, want_dk = depthwise.depthwise3x3_reference_backward(
        xt, torch.from_numpy(k), gt, 1)
    dx, rows, dk = emulate_s1_backward(xt.float().numpy(), k,
                                       gt.float().numpy(), th, segs, blocks,
                                       lanes, run)
    assert rows.shape == (blocks, 9, c)
    if dtype == torch.bfloat16:
        dx = _bf16_round(dx)
    np.testing.assert_array_equal(dx, want_dx.float().numpy())
    rel = np.linalg.norm(dk.astype(np.float64) - want_dk.double().numpy()) \
        / np.linalg.norm(want_dk.double().numpy())
    assert rel <= 1e-5


ROOT = Path(__file__).resolve().parent.parent
DW_CU =ROOT / "torch_semantic_segmentation_tpu_torch" / "csrc" / "depthwise.cu"
DW_PROBE = ROOT / "scripts" / "torch_dw_bwd_probe.py"


@pytest.mark.parametrize("variant", ["k6b_no_dk", "k6b_no_dx", "k6b1_no_dk",
                                     "k6b1_no_dx"])
def test_probe_variant_patches_only_its_kernel(variant):
    """Each variant of `scripts/torch_dw_bwd_probe.py` names one kernel that
    `depthwise.cu` defines and changes lines inside that kernel's body only,
    each of its texts found once (a probe that patched another kernel would
    time the wrong one)."""
    check_variant(DW_CU, DW_PROBE, variant)


def test_learning_to_downsample_train_bf16_matches_routed_jax(monkeypatch):
    monkeypatch.setenv("TPU_SEG_PALLAS_DW_MIN_PX", "0")
    monkeypatch.setenv("FASTSCNN_PACKED_LDS", "0")
    monkeypatch.setattr(pallas_dw, "routing_enabled", lambda: True)
    real = pallas_dw.depthwise_conv3x3
    port_real = depthwise.depthwise_conv3x3
    j_calls, t_calls = [], []

    def interp_kernel(x, k, *, stride=1, interpret=False):
        j_calls.append((x.shape, stride))
        return real(x, k, stride=stride, interpret=True)

    def spy(x, k, stride):
        t_calls.append((tuple(x.shape), stride))
        return port_real(x, k, stride)

    monkeypatch.setattr(pallas_dw, "depthwise_conv3x3", interp_kernel)
    monkeypatch.setattr(depthwise, "depthwise_conv3x3", spy)
    monkeypatch.setattr(tconv, "DEPTHWISE_MIN_PX", 0)

    j = JLearningToDownsample(3, (32, 48, 64), dtype=jnp.bfloat16,
                              rngs=nnx.Rngs(0))
    t = LearningToDownsample(3, (32, 48, 64), compute_dtype=torch.bfloat16)
    randomize_bn(j, np.random.default_rng(4))
    t.load_state_dict(state_dict_from_jax(export_torch_state_dict(j)),
                      strict=True)
    j.train()
    t.train()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    ct = rng.normal(size=(2, 4, 8, 64)).astype(np.float32)

    def loss(m, xx):
        y = m(xx)
        return jnp.sum(y.astype(jnp.float32) * ct), y

    (_, want_y), (gm, gx) = nnx.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(j, xj)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    xt.requires_grad_(True)
    y = t(xt)
    (y.float() * torch.from_numpy(ct)).sum().backward()
    assert [s for _, s in j_calls] == [2, 2]
    assert t_calls == [((2, 16, 32, 32), 2), ((2, 8, 16, 48), 2)]

    assert y.dtype == torch.bfloat16
    assert _rel(y.detach().float().numpy(), np.asarray(want_y, np.float32)) \
        < 2e-2
    assert _rel(xt.grad.float().numpy(), np.asarray(gx, np.float32)) < 2e-2
    c = nnx.clone(j)
    nnx.update(c, gm)
    got = dict(t.named_parameters())
    for key, r in export_torch_state_dict(c).items():
        if key.endswith(("running_mean", "running_var")):
            continue
        assert _rel(got[key].grad.float().numpy(), r) < 4e-2, key
    for name in ("conv", "ds1.dw", "ds1.pw", "ds2.dw", "ds2.pw"):
        tm = t.get_submodule(name).bn
        jm = j
        for part in name.split("."):
            jm = getattr(jm, part)
        np.testing.assert_allclose(tm.running_mean.numpy(),
                                   np.asarray(jm.bn.mean[...], np.float32),
                                   rtol=1e-2, atol=1e-3, err_msg=name)


def _block(**kw):
    args = dict(stride=2, groups=8, act="relu", compute_dtype=torch.bfloat16)
    args.update(kw)
    return tconv.ConvBNAct(8, 8, 3, **args)


# (what changes, ConvBNAct arguments, x dtype, pixel floor, routed)
ROUTING_CASES = [
    ("stride 2 bf16", {}, torch.bfloat16, 0, True),
    ("stride 2 float32", {"compute_dtype": None}, torch.float32, 0, True),
    ("stride 1", {"stride": 1}, torch.bfloat16, 0, False),
    ("bias", {"use_bias": True}, torch.bfloat16, 0, False),
    ("dilation 2", {"dilation": 2}, torch.bfloat16, 0, False),
    ("not depthwise", {"groups": 1}, torch.bfloat16, 0, False),
    ("below the floor", {}, torch.bfloat16, 2 * 16 * 32 + 1, False),
    ("at the floor", {}, torch.bfloat16, 2 * 16 * 32, True),
    ("compute dtype bf16, x float32", {}, torch.float32, 0, False),
    ("compute dtype float32, x bf16", {"compute_dtype": torch.float32},
     torch.bfloat16, 0, False),
    ("float16", {"compute_dtype": None}, torch.float16, 0, False),
]


@pytest.mark.parametrize("what,kw,dtype,floor,routed", ROUTING_CASES,
                         ids=[c[0] for c in ROUTING_CASES])
def test_routing_predicate(monkeypatch, what, kw, dtype, floor, routed):
    monkeypatch.setattr(tconv, "DEPTHWISE_MIN_PX", floor)
    block = _block(**kw)
    x = torch.zeros((2, 16, 32, 8), dtype=dtype)
    assert (block._maybe_depthwise(x) is not None) == routed


def test_routed_conv_matches_plain_conv_in_float32():
    """The routed stride-2 conv and the plain one agree in float32 (the
    float32 kernel is then the conv's own)."""
    block = _block(compute_dtype=None)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 16, 32, 8)).astype(np.float32))
    k = block.conv.weight.reshape(8, 3, 3).permute(1, 2, 0)
    torch.testing.assert_close(depthwise.depthwise_conv3x3(x, k, 2),
                               block.conv(x), rtol=1e-5, atol=1e-5)
