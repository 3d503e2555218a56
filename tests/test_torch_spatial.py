"""PyTorch port, spatial sharding's ops on the CPU, without ranks: the
guards against the JAX package's, and each band-aware op on the bands of
one process's tensor against the op on the whole tensor.

`Bands` runs an op as band s of S in this process: `distributed`'s
spatial layout is patched to band s, its halo exchange takes the halo rows
from the global tensor the band is a view of (so that their gradients
reach those rows, as the exchange's backward sends them), and its sum over
the data row's bands is the identity (the test sums the bands' parts).
Float32 at 1e-6; bit for bit where the band does the same arithmetic."""

import contextlib

import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu.parallel import (
    check_spatial_extent as j_check_spatial_extent)
from torch_semantic_segmentation_tpu_torch import losses
from torch_semantic_segmentation_tpu_torch.ops import (
    conv as conv_ops, depthwise, mbconv, pool, upsample)
from torch_semantic_segmentation_tpu_torch.ops.conv import (
    ConvBNAct, band_halo)
from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout
from torch_semantic_segmentation_tpu_torch.ops.resize_ce import (
    _label_weights)
from torch_semantic_segmentation_tpu_torch.parallel import (
    check_even_split, check_spatial_extent, distributed, shard_batch)

torch.set_num_threads(2)


class Bands:
    """Band s of `n` of a global tensor, run in this process."""

    def __init__(self, n: int):
        self.n = n
        self._of: dict[int, tuple[torch.Tensor, int]] = {}

    def take(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """Rows [s·H/n, (s+1)·H/n) of x (N, H, ...): a view whose halo
        rows `halo` reads from x."""
        per = x.shape[1] // self.n
        band = x[:, s * per:(s + 1) * per]
        self._of[id(band)] = (x, s)
        return band

    def _halo(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        whole, s = self._of[id(x)]
        per = x.shape[1]
        lo = max(0, s * per - top)
        hi = min(whole.shape[1], (s + 1) * per + bottom)
        return whole[:, lo:hi]

    @contextlib.contextmanager
    def rank(self, s: int):
        """Within the block the port's ops run as band s of n."""
        patched = dict(is_spatial=lambda: True, num_spatial=lambda: self.n,
                       spatial_rank=lambda: s, data_size=lambda: 1,
                       halo=self._halo, spatial_sum=lambda x: x)
        saved = {k: getattr(distributed, k) for k in patched}
        for k, v in patched.items():
            setattr(distributed, k, v)
        try:
            yield
        finally:
            for k, v in saved.items():
                setattr(distributed, k, v)

    def run(self, fn, x: torch.Tensor) -> list:
        """fn of each band of x, in band order."""
        out = []
        for s in range(self.n):
            band = self.take(x, s)
            with self.rank(s):
                out.append(fn(band))
        return out


def _rng_tensor(seed, *shape, dtype=torch.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32)).to(dtype)


# --- the guards ---

@pytest.mark.parametrize("h,n", [(128, 4), (64, 4), (64, 2), (32, 2),
                                 (96, 4), (16, 1)])
def test_check_spatial_extent_matches_jax(h, n):
    """The JAX package's cases (tests/test_parallel_fastpaths.py): raises
    "degenerate spatial sharding" where theirs does, and passes where
    theirs does."""
    try:
        j_check_spatial_extent(h, n)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        check_spatial_extent(h, n)
        check_spatial_extent(h, n, max_stride=32)
    else:
        assert want.startswith("degenerate spatial sharding")
        with pytest.raises(ValueError, match="degenerate spatial sharding"):
            check_spatial_extent(h, n)


@pytest.mark.parametrize("h,n,ok", [(128, 2, True), (128, 4, True),
                                    (96, 2, False), (192, 4, False),
                                    (1024, 2, True), (1056, 2, False)])
def test_even_split_guard(h, n, ok):
    """Equal bands aligned with every stride-2 stage: H % (n · 32) == 0,
    where the JAX package lets GSPMD pad."""
    if ok:
        check_even_split(h, n)
    else:
        with pytest.raises(ValueError, match="uneven spatial split"):
            check_even_split(h, n)


def test_shard_batch_guards_without_a_group():
    """Without a group `shard_batch(spatial=True)` is the batch itself,
    after both guards on a band of one."""
    x, y = torch.zeros(2, 64, 32, 3), torch.zeros(2, 64, 32)
    a, b = shard_batch((x, y), spatial=True)
    assert a is not None and a.shape == x.shape and b.shape == y.shape
    with pytest.raises(ValueError, match="degenerate"):
        shard_batch((x[:, :16], y[:, :16]), spatial=True)
    with pytest.raises(ValueError, match="uneven"):
        shard_batch((x[:, :48], y[:, :48]), spatial=True)


def test_other_models_and_multiscale_refuse_spatial(monkeypatch):
    """Under spatial sharding what stays refused: a module that is not a
    zoo class (the gate, the train step), remat, an uneven split and a
    multi-scale scale whose rows do not split into bands of the model's
    stride; every zoo model builds and makes its train, eval and
    multi-scale steps (`tests/test_torch_spatial_zoo.py` holds the gate
    over all 13 names)."""
    from torch_semantic_segmentation_tpu_torch.eval import (
        make_multiscale_eval_step)
    from torch_semantic_segmentation_tpu_torch.models import (
        available_models, check_spatial_model, get_model)
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_eval_step, make_train_step)
    lednet = get_model("lednet", 5, device="cpu")
    enet = get_model("enet", 5, device="cpu")
    other = torch.nn.Conv2d(3, 5, 1)
    monkeypatch.setattr(distributed, "is_spatial", lambda: True)
    monkeypatch.setattr(distributed, "num_spatial", lambda: 4)
    for name in available_models():
        check_spatial_model(name)
    for m in (get_model("contextnet", 5, device="cpu"), lednet, enet):
        check_spatial_model(m)
        make_train_step(m, create_train_state(m, OptimizerConfig()),
                        device="cpu")
        make_eval_step(m, num_classes=5, device="cpu")
        make_multiscale_eval_step(m, num_classes=5, device="cpu")
    with pytest.raises(NotImplementedError, match="Conv2d is not one of"):
        check_spatial_model(other)
    with pytest.raises(NotImplementedError, match="Conv2d is not one of"):
        make_train_step(other, create_train_state(lednet, OptimizerConfig()),
                        device="cpu")
    fast = get_model("fastscnn", 5, device="cpu")
    state = create_train_state(fast, OptimizerConfig())
    make_train_step(fast, state, device="cpu")
    with pytest.raises(NotImplementedError, match="remat"):
        make_train_step(fast, state, remat=True, device="cpu")
    with pytest.raises(ValueError, match="uneven spatial split"):
        check_even_split(96, 4, lednet.max_stride)
    # LEDNet on bands of 64 rows of a 256-row image: scale 0.5 gives 128
    # rows, which 4 bands of a multiple of 64 rows cannot hold
    step = make_multiscale_eval_step(lednet, num_classes=5, device="cpu")
    with pytest.raises(ValueError, match="scale 0.5: 128 rows do not split "
                       "into 4 spatial bands of a multiple of the model's "
                       "max_stride 64"):
        step(torch.zeros(5, 5, dtype=torch.int64), torch.zeros(1, 64, 32, 3),
             torch.zeros(1, 64, 32, dtype=torch.int64))


def test_shard_batch_refuses_lednet_at_128_rows_on_4_bands(monkeypatch):
    """LEDNet's APN reaches 1/64: on 4 spatial ranks a 128-row image has 2
    rows there, fewer than the bands, so `shard_batch` at LEDNet's
    `max_stride` refuses it as degenerate, where the JAX package's
    default of 32 (4 rows at 1/32) lets it through; 256 rows pass."""
    from torch_semantic_segmentation_tpu_torch.models import LEDNet
    monkeypatch.setattr(distributed, "num_spatial", lambda: 4)
    monkeypatch.setattr(distributed, "world_size", lambda: 4)
    monkeypatch.setattr(distributed, "rank", lambda: 1)
    x, y = torch.zeros(2, 128, 32, 3), torch.zeros(2, 128, 32)
    with pytest.raises(ValueError, match="degenerate spatial sharding: "
                       "input H=128 reaches H=2 at stride 64"):
        shard_batch((x, y), spatial=True, max_stride=LEDNet.max_stride)
    a, b = shard_batch((x, y), spatial=True, max_stride=32)
    assert a.shape == (2, 32, 32, 3) and b.shape == (2, 32, 32)
    x2 = torch.arange(2 * 256, dtype=torch.float32).reshape(2, 256, 1, 1)
    (a,) = shard_batch((x2,), spatial=True, max_stride=LEDNet.max_stride)
    assert torch.equal(a, x2[:, 64:128])


# --- the convolutions ---

# (kernel, stride, dilation, groups): the LDS's first conv, a stride-1 3×3,
# the stride-2 depthwise of the LDS and GFE, the FFM's dilated depthwise,
# a 1×1
CONVS = [(3, 2, 1, 1), (3, 1, 1, 1), (3, 2, 1, 8), (3, 1, 4, 8),
         (1, 1, 1, 1)]


def _conv(k, stride, dil, groups, dtype=None) -> ConvBNAct:
    c = ConvBNAct(8, 8, k, stride=stride, dilation=dil, groups=groups,
                  act=None, compute_dtype=dtype,
                  generator=torch.Generator().manual_seed(k * 10 + stride))
    c.bn = None
    return c


@pytest.mark.parametrize("k,stride,dil,groups", CONVS)
@pytest.mark.parametrize("n", [2, 4])
def test_conv_on_bands(k, stride, dil, groups, n):
    """A conv on band + halo, cropped, gives the band's rows of the conv
    of the whole image, and its input gradient; no halo at the image's
    edges, where the padding is the global one."""
    conv = _conv(k, stride, dil, groups)
    x = _rng_tensor(1, 2, 32, 12, 8).requires_grad_(True)
    g = _rng_tensor(2, 2, 32 // stride, 12 // stride, 8)
    want = conv(x)
    (want * g).sum().backward()
    dx_want, x.grad = x.grad, None
    bands = Bands(n)
    got = bands.run(conv, x)
    per = g.shape[1] // n
    for s, y in enumerate(got):
        (y * g[:, s * per:(s + 1) * per]).sum().backward()
    torch.testing.assert_close(torch.cat(got, dim=1), want, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(x.grad, dx_want, rtol=1e-6, atol=1e-6)


def test_band_halo_rows():
    """Stride 2 with padding 1 takes a top halo of 2 rows and no bottom
    one (a top halo of 1 would put the local grid off by half a row);
    stride 1 takes d rows each side; a 1×1 none."""
    assert band_halo(3, 2, 1) == (2, 0)
    assert band_halo(3, 1, 1) == (1, 1)
    assert band_halo(3, 1, 4, 4) == (4, 4)
    assert band_halo(1, 1, 0) == (0, 0)


@pytest.mark.parametrize("n", [2, 4])
def test_k6_plain_version_on_bands(monkeypatch, n):
    """The routed stride-2 depthwise conv (K6's plain version in bf16) on
    band + a 2-row top halo equals the global routed conv bit for bit,
    input gradient too; the route is decided on the global H, so a band
    below the pixel floor routes as the whole image does."""
    x = _rng_tensor(3, 2, 64, 32, 8, dtype=torch.bfloat16)
    conv = _conv(3, 2, 1, 8, torch.bfloat16)
    calls = []
    real = depthwise.depthwise_conv3x3
    monkeypatch.setattr(depthwise, "depthwise_conv3x3",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    monkeypatch.setattr(conv_ops, "DEPTHWISE_MIN_PX", 2 * 64 * 32)
    x.requires_grad_(True)
    g = _rng_tensor(4, 2, 32, 16, 8, dtype=torch.bfloat16)
    want = conv(x)
    (want.float() * g.float()).sum().backward()
    dx_want, x.grad = x.grad, None
    assert len(calls) == 1
    got = Bands(n).run(conv, x)
    assert len(calls) == 1 + n            # every band routed
    per = 32 // n
    for s, y in enumerate(got):
        (y.float() * g[:, s * per:(s + 1) * per].float()).sum().backward()
    assert torch.equal(torch.cat(got, dim=1), want)
    torch.testing.assert_close(x.grad.float(), dx_want.float(), rtol=0,
                               atol=1e-2 * float(dx_want.float().abs().max()))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("n", [2, 4])
def test_k2_plain_version_on_bands(stride, n):
    """The fused expand → depthwise op (K2's plain version) on band +
    halo, zero-padded at the image's edges only: the band's rows of the
    global op, and the gradients of x, W′, b′ and k. A halo row of zeros
    is not the padding here (relu(0·W′ + b′) = relu(b′))."""
    x = _rng_tensor(5, 2, 32, 12, 16, dtype=torch.bfloat16)
    w = _rng_tensor(6, 16, 48, scale=0.3).requires_grad_(True)
    b = (_rng_tensor(7, 48, scale=0.5) + 0.3).requires_grad_(True)
    k = _rng_tensor(8, 3, 3, 48, scale=0.3).requires_grad_(True)
    top, bottom = band_halo(3, stride, 1)

    def op(xb):
        return distributed.on_band(
            lambda xh: mbconv.fused_expand_dw(xh.contiguous(), w, b, k,
                                              stride),
            xb, top, bottom, down=stride)

    x.requires_grad_(True)
    want = op(x)
    g = _rng_tensor(9, *want.shape, dtype=torch.bfloat16)
    (want.float() * g.float()).sum().backward()
    grads_want = [t.grad.clone() for t in (x, w, b, k)]
    for t in (x, w, b, k):
        t.grad = None
    got = Bands(n).run(op, x)
    per = want.shape[1] // n
    for s, y in enumerate(got):
        (y.float() * g[:, s * per:(s + 1) * per].float()).sum().backward()
    assert torch.equal(torch.cat(got, dim=1), want)
    # dx and dW′ come from bf16(dem), which a halo pixel's band rounds in
    # two parts (one from each band it feeds): bf16's bar; db′ and dk sum
    # in float32
    for name, t, gw in zip("x w b k".split(), (x, w, b, k), grads_want):
        scale = float(gw.float().abs().max())
        torch.testing.assert_close(t.grad.float(), gw.float(), rtol=0,
                                   atol=(1e-2 if name in "xw" else 1e-5)
                                   * scale, msg=lambda m, name=name:
                                   f"d{name}: {m}")
    # zero rows in place of the edge's padding give other values
    zero_top = torch.cat([torch.zeros_like(x[:, :2]), x[:, :8]], dim=1)
    y0 = mbconv.fused_expand_dw(zero_top.detach().contiguous(), w, b, k,
                                stride)
    assert not torch.equal(y0[:, 2 // stride:][:, :8 // stride],
                           want[:, :8 // stride])


# --- the resizes and the pools ---

@pytest.mark.parametrize("h,k", [(4, 4), (2, 8), (8, 8), (1, 4)])
@pytest.mark.parametrize("n", [2, 4])
def test_resize_of_a_band(h, k, n):
    """An integer ×k of a band (one halo row each side, none at the
    image's edges, k rows cropped each side) gives the band's rows of the
    global resize, and the gradient of the input; the argmax after a ×k
    resize too (`resize_argmax`)."""
    x = _rng_tensor(10, 2, h * n, 6, 5).requires_grad_(True)
    size = (h * n * k, 6 * k)
    want = upsample.resize_bilinear(x, size)
    g = _rng_tensor(11, *want.shape)
    (want * g).sum().backward()
    dx_want, x.grad = x.grad, None
    got = Bands(n).run(lambda xb: upsample.resize_bilinear(
        xb, (xb.shape[1] * k, size[1])), x)
    per = h * k
    for s, y in enumerate(got):
        (y * g[:, s * per:(s + 1) * per]).sum().backward()
    torch.testing.assert_close(torch.cat(got, dim=1), want, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(x.grad, dx_want, rtol=1e-6, atol=1e-6)
    ids = Bands(n).run(lambda xb: upsample.resize_argmax(
        xb, (xb.shape[1] * k, size[1])), x.detach())
    assert torch.equal(torch.cat(ids, dim=1),
                       upsample.resize_argmax(x.detach(), size))


@pytest.mark.parametrize("bins", [1, 2, 3, 6])
@pytest.mark.parametrize("n", [2, 4])
def test_replicated_resize_takes_the_bands_rows(bins, n):
    """The PPM's bins, the same on every band, resized to the band's rows:
    the band's rows of the global interpolation matrix (the float32 sums
    of two taps, in the order the matrix product's blocking takes)."""
    y = _rng_tensor(12, 2, bins, bins, 4)
    want = upsample.resize_bilinear(y, (8 * n, 12))
    got = []
    for s in range(n):
        with Bands(n).rank(s):
            got.append(upsample.resize_bilinear(y, (8, 12),
                                                source="replicated"))
    torch.testing.assert_close(torch.cat(got, dim=1), want, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_pools_of_bands(n):
    """Adaptive pooling to the PPM's bins and global pooling: the bands'
    parts sum to the global pool (each part is what the band adds to the
    sum over the data row's bands), and so do their input gradients."""
    x = _rng_tensor(13, 2, 4 * n, 6, 4).requires_grad_(True)
    for fn in [lambda t, b=b: pool.adaptive_avg_pool2d(t, b)
               for b in (1, 2, 3, 6)] + [pool.global_avg_pool]:
        want = fn(x)
        g = _rng_tensor(14, *want.shape)
        (want * g).sum().backward()
        dx_want, x.grad = x.grad, None
        parts = Bands(n).run(fn, x)
        for p in parts:
            (p * g).sum().backward()
        torch.testing.assert_close(sum(parts), want, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(x.grad, dx_want, rtol=1e-6, atol=1e-6)
        x.grad = None


@pytest.mark.parametrize("dims", [(), (1, 2)])
def test_dropout_mask_is_the_bands_rows(dims):
    """Train-mode dropout on a band draws at the global H and keeps the
    band's rows: the band's rows of the single process's mask."""
    x = _rng_tensor(15, 2, 16, 4, 3)

    def drop(t):
        d = Dropout(0.5, broadcast_dims=dims,
                    generator=torch.Generator().manual_seed(3))
        d.train()
        return d(t)

    want = drop(x)
    assert torch.equal(torch.cat(Bands(4).run(drop, x), dim=1), want)


# --- K1's plain version on band + halo, with ignored padding ---

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [2, 4])
def test_resize_ce_of_a_band(dtype, n):
    """The resize CE of 1/8 logits on band + one halo row each side, the
    labels padded with 8 rows of ignore_index a halo row (bf16: K1's
    plain version; float32: the plain CE route): every band pixel's loss
    and d(logits) are the global ones, so the bands' shares, each its
    ratio times its Σ w over the global Σ w, sum to the global loss, and
    their gradients to the global d(logits)."""
    rng = np.random.default_rng(16)
    logits = _rng_tensor(17, 2, 2 * n, 6, 5, dtype=dtype, scale=2.0)
    lab = rng.integers(0, 5, (2, 16 * n, 48))
    lab[:, 12:20, :10] = 255
    labels = torch.from_numpy(lab.astype(np.uint8))
    cw = torch.tensor([0.5, 1.0, 1.5, 2.0, 1.2])
    logits.requires_grad_(True)
    want = losses.resize_cross_entropy_loss(logits, labels,
                                            class_weights=cw)
    want.backward()
    dx_want, logits.grad = logits.grad, None
    total_w = _label_weights(labels, cw)[2].sum()
    per = labels.shape[1] // n
    shares = []
    for s in range(n):
        band = Bands(n)
        lb = band.take(logits, s)
        with band.rank(s):
            ratio = losses.resize_cross_entropy_loss(
                lb, labels[:, s * per:(s + 1) * per], class_weights=cw)
        sw = _label_weights(labels[:, s * per:(s + 1) * per], cw)[2].sum()
        shares.append(ratio * sw / total_w)
    total = sum(shares)
    total.backward()
    torch.testing.assert_close(total, want, rtol=1e-6, atol=0)
    tol = (1e-2 if dtype == torch.bfloat16 else 1e-6) * float(
        dx_want.float().abs().max())
    torch.testing.assert_close(logits.grad.float(), dx_want.float(),
                               rtol=0, atol=tol)
