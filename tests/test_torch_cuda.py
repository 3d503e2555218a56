"""PyTorch port, kernels on the card: each Hopper kernel, forward and
backward where it has one, against its plain PyTorch version, the
wrappers' checks and their launch counters; and the input pipeline's
`prefetch_to_device` (pinned ring, side stream). These tests need a CUDA card
and skip without one. This file imports neither JAX nor the JAX package,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu_torch.data import pipeline
from torch_semantic_segmentation_tpu_torch.ops import (
    depthwise, mbconv, resize_ce, sepconv, upsample_concat)

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sepconv_inputs(seed, h, w, c, co, device, n=2):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(n, h, w, c)), rng.normal(size=(3, 3, c)) * 0.2,
              rng.normal(size=(c,)) * 0.1, rng.normal(size=(c, co)) * 0.2,
              rng.normal(size=(co,)) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,co,dil,relu_mid,relu_out", [
    (16, 24, 8, 16, 1, True, True),
    (16, 24, 8, 16, 4, True, False),
    (12, 40, 24, 8, 1, False, True),
    (8, 8, 3, 5, 2, False, False),
    (9, 33, 160, 72, 4, True, True),   # C over one channel chunk, Co ragged
    (9, 33, 64, 136, 4, True, False),  # 16-byte loads, Co over one pass
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sepconv_kernel_matches_plain_version(cuda, h, w, c, co, dil,
                                              relu_mid, relu_out, dtype):
    dtype = getattr(torch, dtype)
    x, dwk, dwb, pwk, pwb = _sepconv_inputs(6, h, w, c, co, cuda)
    args = (x.to(dtype), dwk, dwb, pwk.to(dtype), pwb)
    kw = dict(dilation=dil, relu_mid=relu_mid, relu_out=relu_out)
    before = sepconv.fused_separable_conv.launches
    got = sepconv.fused_separable_conv(*args, **kw).float()
    assert sepconv.fused_separable_conv.launches == before + 1
    want = sepconv.separable_conv_reference(*args, **kw).float()
    torch.cuda.synchronize()
    if dtype == torch.float32:
        tol = dict(rtol=1e-4, atol=1e-4)
    else:
        # the mma sums in another order; a sum on a bf16 boundary may round
        # one step apart: two bf16 steps at the top of the output's range
        tol = dict(rtol=0, atol=2.0 ** -6 * float(want.abs().max()))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)


@pytest.mark.cuda
def test_sepconv_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, dwk, dwb, pwk, pwb = _sepconv_inputs(7, 8, 8, 4, 4, cuda)
    with pytest.raises(ValueError, match="stride"):
        sepconv.fused_separable_conv(x, dwk, dwb, pwk, pwb, stride=2)
    with pytest.raises(ValueError, match="contiguous"):
        sepconv.fused_separable_conv(x.permute(0, 2, 1, 3), dwk, dwb, pwk, pwb)
    with pytest.raises(TypeError):
        sepconv.fused_separable_conv(x.half(), dwk, dwb, pwk.half(), pwb)
    with pytest.raises(TypeError, match="pw kernel"):
        sepconv.fused_separable_conv(x.bfloat16(), dwk, dwb, pwk, pwb)
    with pytest.raises(ValueError, match="must be on"):
        sepconv.fused_separable_conv(x, dwk.cpu(), dwb, pwk, pwb)


# (n, h, w, c, co, d) for the bf16 kernel: C = Co = 128 at d = 1 and 4 (the
# compile-time instances) on and off the 8 x 16 tile's edges; d = 2 and 3
# (the runtime-d instance); C off the 32-channel chunk (40; 20, off the
# 16-byte pieces); Co over one 128-wide group
SEPCONV_BF16_CASES = [(2, 16, 32, 128, 128, 1), (2, 21, 35, 128, 128, 1),
                      (2, 16, 32, 128, 128, 4), (2, 19, 45, 128, 128, 4),
                      (1, 13, 27, 128, 128, 2), (1, 11, 37, 128, 128, 3),
                      (2, 9, 33, 40, 128, 1), (1, 9, 17, 20, 56, 4),
                      (1, 10, 18, 128, 200, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,co,d", SEPCONV_BF16_CASES)
def test_sepconv_bf16_kernel_geometry(cuda, n, h, w, c, co, d):
    x, dwk, dwb, pwk, pwb = _sepconv_inputs(8, h, w, c, co, cuda, n=n)
    args = (x.bfloat16(), dwk, dwb, pwk.bfloat16(), pwb)
    kw = dict(dilation=d, relu_out=d % 2 == 1)
    before = sepconv.fused_separable_conv.launches
    got = sepconv.fused_separable_conv(*args, **kw)
    again = sepconv.fused_separable_conv(*args, **kw)
    assert sepconv.fused_separable_conv.launches == before + 2
    want = sepconv.separable_conv_reference(*args, **kw)
    torch.cuda.synchronize()
    _bf16_close(got, want)
    assert torch.equal(got, again)   # two launches give the same bits


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
def test_sepconv_bf16_unaligned_x_runs_the_kernel(cuda, d):
    """An x whose storage offset breaks 16-byte alignment goes to the
    runtime instance (plain loads), never to the plain version."""
    x, dwk, dwb, pwk, pwb = _sepconv_inputs(9, 12, 20, 128, 128, cuda)
    store = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
    xu = store[1:].view(x.shape)
    xu.copy_(x)
    assert xu.is_contiguous() and xu.data_ptr() % 16 != 0
    args = (xu, dwk, dwb, pwk.bfloat16(), pwb)
    before = sepconv.fused_separable_conv.launches
    got = sepconv.fused_separable_conv(*args, dilation=d)
    assert sepconv.fused_separable_conv.launches == before + 1
    want = sepconv.separable_conv_reference(*args, dilation=d)
    torch.cuda.synchronize()
    _bf16_close(got, want)


def _bf16_close(got, want, scale_of=None):
    """Within two bf16 steps of the largest |want| (sums in another order
    may round one step apart)."""
    want = want.float()
    scale = float((want if scale_of is None else scale_of).abs().max())
    err = float((got.float() - want).abs().max())
    assert err <= 2.0 ** -6 * scale + 1e-6, (err, scale)


# (n, h, w, cin, ce, stride): odd W at stride 1, Ce off the 64-channel chunk,
# ragged Cin, odd H and W at stride 2, the widest Cin the kernel takes
MBCONV_CASES = [(2, 9, 19, 16, 96, 1), (1, 8, 12, 24, 72, 2),
                (2, 7, 13, 12, 40, 2), (1, 5, 33, 128, 136, 1)]


def _mbconv_inputs(seed, n, h, w, cin, ce, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(n, h, w, cin)), rng.normal(size=(cin, ce)) * 0.3,
              rng.normal(size=(ce,)) * 0.5, rng.normal(size=(3, 3, ce)) * 0.5)
    x, wt, b, k = [torch.from_numpy(a.astype(np.float32)).to(device)
                   for a in arrays]
    return x.to(torch.bfloat16), wt, b, k


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,ce,stride", MBCONV_CASES)
def test_mbconv_kernels_match_plain_version(cuda, n, h, w, cin, ce, stride):
    _check_mbconv(cuda, n, h, w, cin, ce, stride)


# ContextNet's context branch at batch 32 (crop 768): Cin 32 / Ce 32 at
# stride 1 on 96x96 (column tiles KT = 2), Cin 32 / Ce 192 at stride 2 on
# 96x96, Cin 48 / Ce 288 at stride 2 on 48x48 (Cin off 32, Ce off 64)
MBCONV_CONTEXTNET_CASES = [(32, 96, 96, 32, 32, 1), (32, 96, 96, 32, 192, 2),
                           (32, 48, 48, 48, 288, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,ce,stride", MBCONV_CONTEXTNET_CASES)
def test_mbconv_kernels_at_contextnet_shapes(cuda, n, h, w, cin, ce, stride):
    _check_mbconv(cuda, n, h, w, cin, ce, stride)


def _check_mbconv(cuda, n, h, w, cin, ce, stride):
    x, wt, b, k = _mbconv_inputs(3, n, h, w, cin, ce, cuda)
    f0, b0 = mbconv.expand_dw_forward.launches, mbconv.expand_dw_backward.launches
    y = mbconv.expand_dw_forward(x, wt, b, k, stride)
    assert mbconv.expand_dw_forward.launches == f0 + 1
    want = mbconv.expand_dw_reference(x, wt, b, k, stride)
    assert y.shape == want.shape and y.dtype == torch.bfloat16
    _bf16_close(y, want)
    g = torch.randn(y.shape, generator=torch.Generator(cuda).manual_seed(0),
                    device=cuda).to(torch.bfloat16)
    got = mbconv.expand_dw_backward(x, wt, b, k, g, stride)
    assert mbconv.expand_dw_backward.launches == b0 + 1
    ref = mbconv.expand_dw_reference_backward(x, wt, b, k, g, stride)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        _bf16_close(a, r)


# (n, h, w, cin, ce, stride) whose backward splits Ce over groups of chunks
# (few tiles): Cin 128 and 96, the last chunk ragged at Ce 392, Ce off the
# 8-channel groups at 70 (the plain-load paths)
MBCONV_SPLIT_CASES = [(2, 8, 16, 128, 768, 1), (1, 9, 17, 96, 576, 2),
                      (2, 32, 64, 64, 392, 1), (1, 5, 9, 20, 70, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,ce,stride", MBCONV_SPLIT_CASES)
def test_mbconv_backward_split_over_chunk_groups(cuda, n, h, w, cin, ce,
                                                 stride):
    """Each output at relative L2 2^-7 of the plain version, as
    `chip_smoke.py` holds the backward at the path shapes (the ReLU mask is
    recomputed on each side; both follow the exact pre-activation's sign,
    `test_mbconv_backward_masks_by_the_exact_sign`)."""
    groups = mbconv._library().mbconv_bwd_groups(n, h, w, cin, ce, stride,
                                                 cuda.index or 0)
    assert 1 < groups <= (ce + 63) // 64
    x, wt, b, k = _mbconv_inputs(5, n, h, w, cin, ce, cuda)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = torch.randn((n, ho, wo, ce), generator=torch.Generator(
        cuda).manual_seed(1), device=cuda).to(torch.bfloat16)
    got = mbconv.expand_dw_backward(x, wt, b, k, g, stride)
    ref = mbconv.expand_dw_reference_backward(x, wt, b, k, g, stride)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16
    for name, a, r in zip(("dx", "dW", "db", "dk"), got, ref):
        assert a.shape == r.shape, name
        rel = float((a.float() - r.float()).norm()
                    / r.float().norm().clamp_min(1e-30))
        assert rel <= 2.0 ** -7, (name, rel)


# (n, h, w, cin, ce, stride) whose pre-activations all lie within their
# float32 rounding error of 0: Cin of 64, 128, 96 and a ragged 20
MBCONV_SIGN_CASES = [(2, 8, 16, 64, 384, 1), (1, 9, 17, 128, 768, 2),
                     (2, 12, 20, 96, 576, 1), (1, 5, 9, 20, 70, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,ce,stride", MBCONV_SIGN_CASES)
def test_mbconv_backward_masks_by_the_exact_sign(cuda, n, h, w, cin, ce,
                                                stride):
    """Every pixel holds one x vector and b′ = −float32(x·W′), so each
    channel's exact pre-activation is the float32 rounding error of x·W′
    and the tensor cores' float32 sum lands on either side of 0. The
    kernel takes the exact sum there, as the plain version does: db′ is 0
    on the same channels, and each output is within 2^-9 relative L2 of
    the plain version (the bar of `chip_smoke.check_recorded`)."""
    rng = np.random.default_rng(7)
    x0 = torch.from_numpy(rng.normal(size=cin).astype(np.float32)).to(
        torch.bfloat16)
    wt = torch.from_numpy((rng.normal(size=(cin, ce)) * 0.3).astype(
        np.float32)).to(torch.bfloat16).float()
    exact = x0.double().numpy() @ wt.double().numpy()
    b = torch.from_numpy(-exact.astype(np.float32))
    exact += b.double().numpy()
    assert (exact > 0).any() and (exact < 0).any()
    k = torch.from_numpy(rng.normal(size=(3, 3, ce)).astype(np.float32))
    x = x0.reshape(1, 1, 1, cin).expand(n, h, w, cin).contiguous()
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = torch.from_numpy(rng.normal(size=(n, ho, wo, ce)).astype(np.float32))
    x, wt, b, k, g = (t.to(cuda) for t in (x, wt, b, k, g.to(torch.bfloat16)))
    got = mbconv.expand_dw_backward(x, wt, b, k, g, stride)
    ref = mbconv.expand_dw_reference_backward(x, wt, b, k, g, stride)
    torch.cuda.synchronize()
    assert torch.equal(got[2] == 0, ref[2] == 0)
    for name, a, r in zip(("dx", "dW", "db", "dk"), got, ref):
        assert a.shape == r.shape, name
        rel = float((a.float() - r.float()).norm()
                    / r.float().norm().clamp_min(1e-30))
        assert rel <= 2.0 ** -9, (name, rel)


# (n, h, w, cin, ce, stride) whose forward splits Ce over groups of chunks
# (few tiles): the two 32x64 path shapes at batch 1-2 (Ce 576 and 768), a
# ragged last group (Ce 392; Ce 70 off the 8-channel groups, the plain-load
# paths), stride 2 with odd H and W
MBCONV_FWD_SPLIT_CASES = [(2, 32, 64, 96, 576, 1), (1, 32, 64, 128, 768, 1),
                          (2, 32, 64, 64, 392, 1), (1, 5, 9, 20, 70, 2),
                          (1, 9, 17, 96, 576, 2), (2, 7, 13, 64, 392, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,ce,stride", MBCONV_FWD_SPLIT_CASES)
def test_mbconv_forward_split_over_chunk_groups(cuda, n, h, w, cin, ce,
                                                stride):
    """y within two bf16 steps of its scale, as `chip_smoke.py` holds it."""
    x, wt, b, k = _mbconv_inputs(6, n, h, w, cin, ce, cuda)
    f0 = mbconv.expand_dw_forward.launches
    y = mbconv.expand_dw_forward(x, wt, b, k, stride)
    assert mbconv.expand_dw_forward.launches == f0 + 1
    want = mbconv.expand_dw_reference(x, wt, b, k, stride)
    torch.cuda.synchronize()
    assert y.shape == want.shape and y.dtype == torch.bfloat16
    _bf16_close(y, want)


@pytest.mark.cuda
def test_mbconv_autograd_and_wrapper_checks(cuda):
    x, wt, b, k = _mbconv_inputs(4, 1, 6, 10, 16, 64, cuda)
    xr = x.clone().requires_grad_(True)
    ts = [t.clone().requires_grad_(True) for t in (wt, b, k)]
    mbconv.fused_expand_dw(xr, *ts, 1).float().sum().backward()
    assert xr.grad.dtype == torch.bfloat16 and ts[0].grad.dtype == torch.float32
    with pytest.raises(TypeError):
        mbconv.expand_dw_forward(x.float(), wt, b, k, 1)
    with pytest.raises(ValueError, match="contiguous"):
        mbconv.expand_dw_forward(x.permute(0, 2, 1, 3), wt, b, k, 1)
    with pytest.raises(ValueError, match="stride"):
        mbconv.expand_dw_forward(x, wt, b, k, 3)
    with pytest.raises(ValueError, match="shape"):
        mbconv.expand_dw_forward(x, wt[:, :8], b, k, 1)
    with pytest.raises(ValueError, match="must be on"):
        mbconv.expand_dw_forward(x, wt.cpu(), b, k, 1)
    wide = torch.zeros(1, 4, 4, 136, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="Cin"):
        mbconv.expand_dw_forward(wide, torch.zeros(136, 8, device=cuda),
                                 b[:8], k[..., :8], 1)


# (n, h, w, c, oh, ow, align_corners): OW off 128, C of 3, 19 and 66; then
# shapes whose backward crosses spans and bands: x8 with 3 spans and 3
# bands, both ragged; C of 66 (three class groups); a non-integer ratio
# with align_corners; x8 with four 16-column tiles; then x16, K3's ratio on
# DeepLab's path: ragged, W under one tile, C of 66 with align_corners, C
# of 3, and W over two of K3's phase-A spans; then off the forward's
# geometry (runs of 8 columns a thread, spans of at most 128 runs, bands of
# 8 rows): OW off the run, two spans whose last run is ragged, OW under one
# run, a ragged last band on the vector paths (W C a multiple of 8, OW of 8)
RESIZE_CE_CASES = [(2, 8, 12, 19, 64, 96, False), (1, 5, 7, 3, 40, 56, True),
                   (2, 6, 20, 66, 48, 160, False), (1, 16, 16, 19, 128, 128, True),
                   (2, 19, 70, 19, 152, 560, False), (1, 13, 37, 66, 104, 296, False),
                   (1, 12, 20, 19, 100, 170, True), (1, 16, 64, 19, 128, 512, False),
                   (2, 6, 5, 19, 96, 80, False), (1, 7, 9, 66, 112, 144, True),
                   (1, 3, 2, 3, 48, 32, False), (1, 4, 90, 19, 64, 1440, False),
                   (2, 5, 21, 66, 80, 336, False),
                   (1, 6, 9, 19, 48, 70, False), (1, 4, 130, 19, 32, 1037, False),
                   (1, 3, 2, 19, 24, 5, False), (2, 9, 40, 19, 76, 320, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,oh,ow,ac", RESIZE_CE_CASES)
@pytest.mark.parametrize("label_dtype", ["uint8", "int64"])
@pytest.mark.parametrize("weights", [False, True])
def test_resize_ce_kernels_match_plain_version(cuda, n, h, w, c, oh, ow, ac,
                                               label_dtype, weights):
    _check_resize_ce(cuda, n, h, w, c, oh, ow, ac, label_dtype, weights)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 32])
@pytest.mark.parametrize("label_dtype", ["uint8", "int32"])
def test_resize_ce_kernels_at_lednet_and_contextnet_shape(cuda, n,
                                                          label_dtype):
    """K1 at LEDNet's (n = 8) and ContextNet's (n = 32) training heads,
    (n,96,96,19) → (n,768,768): the forward the same bits twice, both
    directions against the plain version."""
    _check_resize_ce(cuda, n, 96, 96, 19, 768, 768, False, label_dtype, False)
    logits, labels, cw = _resize_ce_inputs(9, n, 96, 96, 19, 768, 768,
                                           label_dtype, cuda)
    first = resize_ce.resize_ce_forward(logits, labels, cw)
    second = resize_ce.resize_ce_forward(logits, labels, cw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _check_resize_ce(cuda, n, h, w, c, oh, ow, ac, label_dtype, weights):
    rng = np.random.default_rng(5)
    logits = torch.from_numpy((rng.normal(size=(n, h, w, c)) * 2).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    lab = rng.integers(0, c, (n, oh, ow))
    lab[:, :3, :7] = 255
    labels = torch.from_numpy(lab.astype(label_dtype)).to(cuda)
    cw = torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)).to(cuda) \
        if weights else torch.ones(c, device=cuda)
    f0 = resize_ce.resize_ce_forward.launches
    b0 = resize_ce.resize_ce_backward.launches
    loss, s2, logz = resize_ce.resize_ce_forward(logits, labels, cw, ac)
    assert resize_ce.resize_ce_forward.launches == f0 + 1
    want = resize_ce.resize_ce_reference(logits, labels, cw, ac)
    np.testing.assert_allclose(float(loss), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(float(s2), float(want[1]), rtol=1e-6)
    # logz rounds to bf16: the last bit may differ
    _bf16_close(logz, want[2])
    scale = torch.tensor([0.7], device=cuda) / s2
    dx = resize_ce.resize_ce_backward(logits, labels, cw, logz, scale, ac)
    assert resize_ce.resize_ce_backward.launches == b0 + 1
    ref = resize_ce.resize_ce_reference_backward(logits, labels, cw, logz,
                                                 scale, ac)
    torch.cuda.synchronize()
    assert dx.dtype == torch.bfloat16 and dx.shape == logits.shape
    _bf16_close(dx, ref)


def _resize_ce_inputs(seed, n, h, w, c, oh, ow, label_dtype, device):
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy((rng.normal(size=(n, h, w, c)) * 2).astype(
        np.float32)).to(device).to(torch.bfloat16)
    lab = rng.integers(0, c, (n, oh, ow))
    lab[:, :3, :7] = 255
    labels = torch.from_numpy(lab.astype(label_dtype)).to(device)
    cw = torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)).to(device)
    return logits, labels, cw


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,oh,ow", [(2, 32, 64, 19, 256, 512),
                                          (2, 9, 40, 19, 76, 320),
                                          (1, 12, 20, 66, 100, 170)])
def test_resize_ce_forwards_give_the_same_bits_twice(cuda, n, h, w, c, oh,
                                                     ow):
    """No atomics: a second launch of K1's forward gives the same loss, S2
    and logz, and of K3's the same map and logz, bit for bit."""
    logits, labels, cw = _resize_ce_inputs(8, n, h, w, c, oh, ow, "uint8",
                                           cuda)
    first = resize_ce.resize_ce_forward(logits, labels, cw)
    second = resize_ce.resize_ce_forward(logits, labels, cw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    first = resize_ce.resize_ce_map_forward(logits, labels)
    second = resize_ce.resize_ce_map_forward(logits, labels)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 19, 66])
def test_resize_ce_forward_instances_run_the_kernel(cuda, c):
    """C = 19 takes the unrolled instance, 3 and 66 the runtime one: each
    launches the kernel (the counters move) and agrees with the plain
    version."""
    logits, labels, cw = _resize_ce_inputs(9, 2, 16, 32, c, 128, 256,
                                           "int32", cuda)
    f0 = resize_ce.resize_ce_forward.launches
    m0 = resize_ce.resize_ce_map_forward.launches
    loss, s2, logz = resize_ce.resize_ce_forward(logits, labels, cw)
    loss_map, logz3 = resize_ce.resize_ce_map_forward(logits, labels)
    assert resize_ce.resize_ce_forward.launches == f0 + 1
    assert resize_ce.resize_ce_map_forward.launches == m0 + 1
    want = resize_ce.resize_ce_reference(logits, labels, cw)
    np.testing.assert_allclose(float(loss), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(float(s2), float(want[1]), rtol=1e-6)
    _bf16_close(logz, want[2])
    assert torch.equal(logz, logz3)
    want_map, _ = resize_ce.resize_ce_map_reference(logits, labels)
    torch.testing.assert_close(loss_map, want_map, rtol=0,
                               atol=1e-5 * float(want_map.abs().max()))


@pytest.mark.cuda
def test_resize_ce_all_ignored_and_wrapper_checks(cuda):
    logits = torch.randn(1, 4, 8, 5, device=cuda).to(torch.bfloat16)
    labels = torch.full((1, 32, 64), 255, dtype=torch.uint8, device=cuda)
    lg = logits.clone().requires_grad_(True)
    loss = resize_ce.resize_cross_entropy(lg, labels)
    loss.backward()
    assert float(loss.detach()) == 0.0 and not bool(lg.grad.float().any())
    cw = torch.ones(5, device=cuda)
    with pytest.raises(TypeError):
        resize_ce.resize_ce_forward(logits.float(), labels, cw)
    with pytest.raises(TypeError):
        resize_ce.resize_ce_forward(logits, labels.float(), cw)
    with pytest.raises(ValueError, match="contiguous"):
        resize_ce.resize_ce_forward(logits.transpose(1, 2), labels, cw)
    with pytest.raises(ValueError, match="class weights"):
        resize_ce.resize_ce_forward(logits, labels, cw[:3])
    with pytest.raises(ValueError, match="must be on"):
        resize_ce.resize_ce_forward(logits, labels.cpu(), cw)


# (n, h, w, c, stride): the LDS convs ds1 and ds2 at batch 8 full
# resolution, the stride-1 case at the GFE's width; odd H and W, C of 3, 20
# and 384 (off the 8-channel groups, and GFE stage1[0]'s width); C of 1200
# and 2048, whose forward tiles fit one buffer of shared memory, not two;
# odd H and W whose last stride-2 backward tiles are ragged in both
# directions, over few tiles and over many tiles a block
DEPTHWISE_CASES = [(8, 512, 1024, 32, 2), (8, 256, 512, 48, 2),
                   (8, 128, 256, 128, 1), (2, 9, 13, 3, 2), (1, 7, 11, 20, 2),
                   (2, 9, 13, 20, 1), (2, 6, 10, 384, 2), (1, 5, 9, 384, 1),
                   (1, 6, 7, 1200, 1), (1, 5, 9, 2048, 2), (3, 37, 53, 40, 2),
                   (4, 301, 517, 40, 2),
                   # ContextNet's detail ds1 and ds2 at batch 32 (crop 768)
                   (32, 384, 384, 32, 2), (32, 192, 192, 64, 2)]


def _depthwise_inputs(seed, n, h, w, c, stride, device):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=g, device=device)
    k = torch.randn((3, 3, c), generator=g, device=device) * 0.5
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    dy = torch.randn((n, ho, wo, c), generator=g, device=device)
    return x, k, dy


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,stride", DEPTHWISE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depthwise_kernels_match_plain_version(cuda, n, h, w, c, stride,
                                               dtype):
    """The forward equal to the plain version bit for bit, and so the
    stride-1 dx, which is the forward's kernel with the taps flipped; the
    stride-2 dx bit for bit too (the same products summed in the same
    order); dk at a relative L2 error of 1e-5 and the same bit for bit from
    launch to launch."""
    dtype = getattr(torch, dtype)
    x, k, dy = _depthwise_inputs(8, n, h, w, c, stride, cuda)
    x, dy = x.to(dtype), dy.to(dtype)
    f0 = depthwise.depthwise3x3_forward.launches
    b0 = depthwise.depthwise3x3_backward.launches
    y = depthwise.depthwise3x3_forward(x, k, stride)
    assert depthwise.depthwise3x3_forward.launches == f0 + 1
    want = depthwise.depthwise3x3_reference(x, k, stride)
    dx, dk = depthwise.depthwise3x3_backward(x, k, dy, stride)
    _, dk2 = depthwise.depthwise3x3_backward(x, k, dy, stride)
    assert depthwise.depthwise3x3_backward.launches == b0 + 2
    rdx, rdk = depthwise.depthwise3x3_reference_backward(x, k, dy, stride)
    torch.cuda.synchronize()
    assert y.dtype == dtype and dx.dtype == dtype and dk.dtype == torch.float32
    assert y.shape == want.shape and torch.equal(y, want)
    assert dx.shape == rdx.shape and torch.equal(dx, rdx)
    assert _rel_l2(dk, rdk) <= 1e-5
    assert torch.equal(dk, dk2)


@pytest.mark.cuda
def test_depthwise_autograd_routing_and_wrapper_checks(cuda):
    from torch_semantic_segmentation_tpu_torch.ops.conv import ConvBNAct
    x, k, _ = _depthwise_inputs(9, 1, 8, 16, 16, 2, cuda)
    xb = x.to(torch.bfloat16).requires_grad_(True)
    kr = k.clone().requires_grad_(True)
    depthwise.depthwise_conv3x3(xb, kr, 2).float().sum().backward()
    assert xb.grad.dtype == torch.bfloat16 and kr.grad.dtype == torch.float32
    # a stride-2 depthwise ConvBNAct at 2^18 input pixels routes to K6
    block = ConvBNAct(8, 8, 3, stride=2, groups=8,
                      compute_dtype=torch.bfloat16).to(cuda)
    f0 = depthwise.depthwise3x3_forward.launches
    block(torch.zeros((1, 512, 512, 8), dtype=torch.bfloat16, device=cuda))
    assert depthwise.depthwise3x3_forward.launches == f0 + 1
    with pytest.raises(TypeError):
        depthwise.depthwise3x3_forward(x.half(), k, 2)
    with pytest.raises(ValueError, match="contiguous"):
        depthwise.depthwise3x3_forward(x.permute(0, 2, 1, 3), k, 2)
    with pytest.raises(ValueError, match="stride"):
        depthwise.depthwise3x3_forward(x, k, 3)
    with pytest.raises(ValueError, match="shape"):
        depthwise.depthwise3x3_forward(x, k[..., :8], 2)
    with pytest.raises(ValueError, match="must be on"):
        depthwise.depthwise3x3_forward(x, k.cpu(), 2)
    wide = torch.zeros((1, 2, 2, 2056), device=cuda)
    with pytest.raises(ValueError, match="C <="):
        depthwise.depthwise3x3_forward(wide, torch.zeros((3, 3, 2056),
                                                         device=cuda), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,oh,ow,ac", RESIZE_CE_CASES)
@pytest.mark.parametrize("label_dtype", ["uint8", "int32"])
def test_resize_ce_map_kernels_match_plain_version(cuda, n, h, w, c, oh, ow,
                                                   ac, label_dtype):
    """K3: the loss map within 1e-5 of its scale (float32 sums in another
    order), logz and d(logits) within two bf16 steps of their scale."""
    _check_map_kernels(cuda, n, h, w, c, oh, ow, ac, label_dtype)


# K3 at BASELINE config 5's ratios: x4 (ICNet's main head at 1/4) and x8
# (BiSeNet's heads at 1/8). The path shapes' geometry, one image each (the
# plan depends on h, w, OH, OW and C alone): ICNet's (256,256) -> (1024,1024)
# and BiSeNet's (128,128) -> (1024,1024); then ragged: W off the 16-column
# tile and OW off the forward's run of 8, C of 66 (three class groups) and
# of 3, align_corners, a forward of two spans at x4 whose last is ragged,
# and a ragged last band of rows
K3_RATIO_CASES = [(1, 256, 256, 19, 1024, 1024, False),
                  (1, 128, 128, 19, 1024, 1024, False),
                  (2, 13, 37, 19, 52, 148, False), (1, 9, 70, 66, 36, 280, False),
                  (2, 7, 21, 3, 28, 84, True), (1, 5, 300, 19, 20, 1200, False),
                  (2, 11, 23, 19, 88, 184, False), (1, 6, 45, 66, 48, 360, True),
                  (2, 3, 33, 19, 24, 264, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,oh,ow,ac", K3_RATIO_CASES)
@pytest.mark.parametrize("label_dtype", ["uint8", "int32"])
def test_resize_ce_map_kernels_at_x4_and_x8(cuda, n, h, w, c, oh, ow, ac,
                                            label_dtype):
    """K3 at x4 and x8 with the bars of the test above."""
    _check_map_kernels(cuda, n, h, w, c, oh, ow, ac, label_dtype)


def _check_map_kernels(cuda, n, h, w, c, oh, ow, ac, label_dtype):
    rng = np.random.default_rng(6)
    logits = torch.from_numpy((rng.normal(size=(n, h, w, c)) * 2).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    lab = rng.integers(0, c, (n, oh, ow))
    lab[:, :3, :7] = 255
    labels = torch.from_numpy(lab.astype(label_dtype)).to(cuda)
    ct = torch.from_numpy(rng.normal(size=(n, oh, ow)).astype(
        np.float32)).to(cuda)
    f0 = resize_ce.resize_ce_map_forward.launches
    b0 = resize_ce.resize_ce_map_backward.launches
    loss_map, logz = resize_ce.resize_ce_map_forward(logits, labels, ac)
    assert resize_ce.resize_ce_map_forward.launches == f0 + 1
    want, want_logz = resize_ce.resize_ce_map_reference(logits, labels, ac)
    assert loss_map.dtype == torch.float32 and loss_map.shape == want.shape
    torch.testing.assert_close(loss_map, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    assert not bool(loss_map[:, :3, :7].any())
    _bf16_close(logz, want_logz)
    dx = resize_ce.resize_ce_map_backward(logits, labels, logz, ct, ac)
    assert resize_ce.resize_ce_map_backward.launches == b0 + 1
    ref = resize_ce.resize_ce_map_reference_backward(logits, labels, logz, ct,
                                                     ac)
    torch.cuda.synchronize()
    assert dx.dtype == torch.bfloat16 and dx.shape == logits.shape
    _bf16_close(dx, ref)
    # no atomics: a second launch gives the same bits
    assert torch.equal(
        resize_ce.resize_ce_map_backward(logits, labels, logz, ct, ac), dx)


@pytest.mark.cuda
def test_resize_ce_map_autograd_and_wrapper_checks(cuda):
    logits = torch.randn(1, 4, 8, 5, device=cuda).to(torch.bfloat16)
    labels = torch.randint(0, 5, (1, 32, 64), device=cuda)
    lg = logits.clone().requires_grad_(True)
    resize_ce.per_pixel_resize_ce(lg, labels).sum().backward()
    assert lg.grad.dtype == torch.bfloat16
    logz = torch.zeros((1, 32, 64), dtype=torch.bfloat16, device=cuda)
    ct = torch.zeros((1, 32, 64), device=cuda)
    with pytest.raises(TypeError):
        resize_ce.resize_ce_map_forward(logits.float(), labels)
    with pytest.raises(ValueError, match="cotangent"):
        resize_ce.resize_ce_map_backward(logits, labels, logz, ct[:, :16])
    with pytest.raises(ValueError, match="logz"):
        resize_ce.resize_ce_map_backward(logits, labels, logz.float(), ct)


# (n, h, w, cl, cs): UNet's up1 at base 16, Cl != Cs, C of 1, 3 and 5, H = W
# = 1, odd H and W, channels off the 8-channel groups
UPSAMPLE_CASES = [(2, 24, 32, 16, 16), (1, 9, 13, 24, 40), (2, 6, 10, 3, 5),
                  (1, 4, 4, 1, 2), (2, 1, 1, 5, 3), (1, 7, 5, 12, 20),
                  (1, 5, 9, 64, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cl,cs", UPSAMPLE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample_concat_kernel_equals_plain_version(cuda, n, h, w, cl, cs,
                                                     dtype):
    """K4 and its plain version round at the same points: the same bits."""
    dtype = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(7)
    low = torch.randn((n, h, w, cl), generator=g, device=cuda).to(dtype)
    skip = torch.randn((n, 2 * h, 2 * w, cs), generator=g, device=cuda).to(dtype)
    before = upsample_concat.upsample_concat_forward.launches
    got = upsample_concat.upsample_concat_forward(low, skip)
    assert upsample_concat.upsample_concat_forward.launches == before + 1
    want = upsample_concat.upsample_concat_reference(low, skip)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_upsample_concat_autograd_and_wrapper_checks(cuda):
    low = torch.randn(1, 4, 6, 8, device=cuda).to(torch.bfloat16)
    skip = torch.randn(1, 8, 12, 8, device=cuda).to(torch.bfloat16)
    lr, sr = low.clone().requires_grad_(True), skip.clone().requires_grad_(True)
    upsample_concat.upsample2x_concat(lr, sr).float().sum().backward()
    assert lr.grad.dtype == torch.bfloat16 and sr.grad.dtype == torch.bfloat16
    # d(low) of a sum is 4 a low pixel: each output pixel's weights sum to 1
    torch.testing.assert_close(lr.grad.float(), torch.full_like(lr.float(), 4.0))
    with pytest.raises(TypeError):
        upsample_concat.upsample_concat_forward(low.float(), skip)
    with pytest.raises(TypeError):
        upsample_concat.upsample_concat_forward(low.half(), skip.half())
    with pytest.raises(ValueError, match="contiguous"):
        upsample_concat.upsample_concat_forward(low.transpose(1, 2).contiguous(
            ).transpose(1, 2), skip)
    with pytest.raises(ValueError, match="must be on"):
        upsample_concat.upsample_concat_forward(low, skip.cpu())


def _host_batches(count, seed=0):
    """`count` distinct host batches of about 4 MiB of images (a strided
    view) and 1 MiB of labels, as numpy uint8."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (4, 512, 683, 3), np.uint8)[:, :, :682],
             rng.integers(0, 256, (4, 512, 512), np.uint8))
            for _ in range(count)]


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_to_device_with_a_slow_consumer(cuda, monkeypatch, size):
    """The consumer's stream lags (a spin on the card) and the host waits
    between batches: every device batch equals its host batch, lives on
    the card, and was copied from one of `size + 1` pinned buffers."""
    import time

    host = _host_batches(7, seed=size)
    sources = []
    real = pipeline._PinnedSlot.buffers

    def buffers(slot, shapes, dtypes):
        out = real(slot, shapes, dtypes)
        sources.append(out)
        return out

    monkeypatch.setattr(pipeline._PinnedSlot, "buffers", buffers)
    got = 0
    for (images, labels), (hi, hl) in zip(
            pipeline.prefetch_to_device(iter(host), size=size), host,
            strict=True):
        assert images.is_cuda and labels.is_cuda
        torch.cuda._sleep(20_000_000)          # the consumer's stream lags
        time.sleep(0.005)
        assert torch.equal(images.cpu(), torch.from_numpy(hi))
        assert torch.equal(labels.cpu(), torch.from_numpy(hl))
        got += 1
    assert got == len(host) == len(sources)
    assert all(t.is_pinned() for pair in sources for t in pair)
    assert len({pair[0].data_ptr() for pair in sources}) == size + 1


@pytest.mark.cuda
def test_prefetch_keeps_up_with_a_fast_consumer(cuda):
    """No wait on the consumer's side: the copies of later batches run on
    the side stream while earlier ones are read; each batch still equals
    its host batch, and a single array passes as a 1-tuple."""
    host = _host_batches(6, seed=9)
    out = [torch.stack([i.sum(dtype=torch.int64), l.sum(dtype=torch.int64)])
           for i, l in pipeline.prefetch_to_device(iter(host), size=2)]
    want = [(int(hi.sum(dtype=np.int64)), int(hl.sum(dtype=np.int64)))
            for hi, hl in host]
    assert [tuple(int(v) for v in t.cpu()) for t in out] == want
    (only,) = pipeline.prefetch_to_device(iter([host[0][1]]))
    assert only[0].is_cuda and torch.equal(only[0].cpu(),
                                           torch.from_numpy(host[0][1]))
