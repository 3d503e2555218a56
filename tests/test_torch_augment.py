"""PyTorch port, the fused train-time augmentation (`data.transforms`) on
the CPU:

- `_warp_batch` and `_color_jitter` against the JAX package's, float32,
  with the same per-image parameters (the two packages draw different
  random numbers from a seed, so the parameters come from one side):
  images within 2e-5, labels exact;
- the JAX package's `test_transforms.py` cases, on the port;
- the laws of the draw (`_sample_params`) as statistics over a few
  thousand images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu.data import transforms as jt
from torch_semantic_segmentation_tpu_torch.data.transforms import (
    AugmentConfig, _color_jitter, _sample_params, _warp_batch, augment_batch,
    normalize_batch)

torch.set_num_threads(2)

H, W, CROP = 64, 96, (48, 64)

# (scales, the uniform draws of the y and x offsets, flips)
WARP_CASES = {
    "downscale, padded": ((0.5, 0.6), (0.3, 0.8), (0.7, 0.2), (False, True)),
    "upscale": ((1.7, 1.25), (0.3, 0.9), (0.6, 0.1), (False, False)),
    "flip": ((1.0, 1.3), (0.5, 0.4), (0.5, 0.9), (True, True)),
}


def _batch(n=2, h=H, w=W, classes=7, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8),
            rng.integers(0, classes, (n, h, w)).astype(np.uint8))


@pytest.mark.parametrize("case", list(WARP_CASES))
def test_warp_batch_matches_jax(case):
    scales, uy, ux, flips = WARP_CASES[case]
    u = torch.zeros((8, 2))
    u[0] = torch.tensor(scales)      # scale_range (0, 1): scale = u[0]
    u[1], u[2] = torch.tensor(uy), torch.tensor(ux)
    p = _sample_params(u, H, W, AugmentConfig(crop=CROP,
                                              scale_range=(0.0, 1.0)))
    flip = torch.tensor(flips)
    images, labels = _batch()
    got_img, got_lbl = _warp_batch(torch.from_numpy(images),
                                   torch.from_numpy(labels), p.scale, p.oy,
                                   p.ox, flip, CROP, 255)
    want_img, want_lbl = jt._warp_batch(
        jnp.asarray(images), jnp.asarray(labels), jnp.asarray(p.scale.numpy()),
        jnp.asarray(p.oy.numpy()), jnp.asarray(p.ox.numpy()),
        jnp.asarray(flip.numpy()), CROP, 255, jnp.float32)
    assert got_img.shape == (2, *CROP, 3) and got_img.dtype == torch.float32
    assert got_lbl.dtype == torch.int32
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got_lbl.numpy(), np.asarray(want_lbl))
    if case == "downscale, padded":
        assert (got_lbl.numpy() == 255).mean() > 0.2
    if case == "upscale":
        assert (got_lbl.numpy() != 255).all()


@pytest.mark.parametrize("hue", [0.0, 0.1])
def test_color_jitter_matches_jax(hue):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    b, c, s = (rng.uniform(0.5, 1.5, 2).astype(np.float32) for _ in range(3))
    h = rng.uniform(-hue, hue, 2).astype(np.float32)
    got = _color_jitter(torch.from_numpy(img), *(torch.from_numpy(v)
                                                  for v in (b, c, s, h)),
                        enable_hue=hue > 0)
    want = jax.vmap(lambda im, bb, cc, ss, hh: jt._color_jitter(
        im, bb, cc, ss, hh, enable_hue=hue > 0))(
            *(jnp.asarray(v) for v in (img, b, c, s, h)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


# the JAX package's tests/test_transforms.py, on the port

def _tbatch(h=32, w=48):
    images, labels = _batch(h=h, w=w)
    return torch.from_numpy(images), torch.from_numpy(labels)


def _no_jitter(**kw):
    base = dict(brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0)
    base.update(kw)
    return AugmentConfig(**base)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_deterministic_under_fixed_generator():
    imgs, lbls = _tbatch()
    cfg = AugmentConfig(crop=(16, 16))
    a1, l1 = augment_batch(imgs, lbls, _gen(42), cfg)
    a2, l2 = augment_batch(imgs, lbls, _gen(42), cfg)
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    torch.testing.assert_close(l1, l2, rtol=0, atol=0)
    a3, _ = augment_batch(imgs, lbls, _gen(7), cfg)
    assert not torch.equal(a1, a3)


def test_static_output_shape():
    imgs, lbls = _tbatch()
    out, lab = augment_batch(imgs, lbls, _gen(0), AugmentConfig(crop=(24, 16)))
    assert out.shape == (2, 24, 16, 3) and out.dtype == torch.float32
    assert lab.shape == (2, 24, 16) and lab.dtype == torch.int32
    out, _ = augment_batch(imgs, lbls, _gen(0), AugmentConfig(
        crop=(24, 16), out_dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16


def test_identity_config_is_exact_normalize():
    imgs, lbls = _tbatch(16, 16)
    cfg = _no_jitter(crop=(16, 16), scale_range=(1.0, 1.0), hflip_prob=0.0)
    out, lab = augment_batch(imgs, lbls, _gen(0), cfg)
    torch.testing.assert_close(out, normalize_batch(imgs), rtol=0, atol=1e-5)
    torch.testing.assert_close(lab, lbls.to(torch.int32), rtol=0, atol=0)


def test_forced_flip_mirrors_exactly():
    imgs, lbls = _tbatch(16, 16)
    cfg = _no_jitter(crop=(16, 16), scale_range=(1.0, 1.0), hflip_prob=1.0)
    out, lab = augment_batch(imgs, lbls, _gen(0), cfg)
    torch.testing.assert_close(out, normalize_batch(imgs).flip(2), rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(lab, lbls.to(torch.int32).flip(2), rtol=0,
                               atol=0)


def test_downscale_pads_labels_with_ignore():
    imgs, lbls = _tbatch(16, 16)
    cfg = _no_jitter(crop=(16, 16), scale_range=(0.5, 0.5), hflip_prob=0.0)
    out, lab = augment_batch(imgs, lbls, _gen(0), cfg)
    lab = lab.numpy()
    assert (lab == 255).mean() > 0.5           # ~3/4 of the crop is padding
    assert (lab[:, 6:10, 6:10] != 255).all()   # the centre keeps labels
    exp = -np.array(cfg.mean) / np.array(cfg.std)
    np.testing.assert_allclose(out[:, 0, 0, :].numpy(), np.tile(exp, (2, 1)),
                               atol=1e-5)


def test_color_jitter_changes_pixels_but_not_labels():
    imgs, lbls = _tbatch(16, 16)
    base = _no_jitter(crop=(16, 16), scale_range=(1.0, 1.0), hflip_prob=0.0)
    jit_cfg = AugmentConfig(crop=(16, 16), scale_range=(1.0, 1.0),
                            hflip_prob=0.0, brightness=0.5, contrast=0.5,
                            saturation=0.5, hue=0.1)
    a0, l0 = augment_batch(imgs, lbls, _gen(3), base)
    a1, l1 = augment_batch(imgs, lbls, _gen(3), jit_cfg)
    assert not torch.allclose(a0, a1)
    torch.testing.assert_close(l0, l1, rtol=0, atol=0)


def test_upscale_crop_stays_in_bounds():
    imgs, lbls = _tbatch(16, 16)
    cfg = _no_jitter(crop=(16, 16), scale_range=(2.0, 2.0), hflip_prob=0.0)
    out, lab = augment_batch(imgs, lbls, _gen(1), cfg)
    assert (lab != 255).all() and bool(torch.isfinite(out).all())


# the draw

def test_augment_batch_draws_one_uniform_block():
    """augment_batch is the warp, the jitter and the normalisation of the
    parameters `_sample_params` maps from one (8, N) draw."""
    imgs, lbls = _tbatch()
    cfg = AugmentConfig(crop=(24, 40), hue=0.05)
    got, got_lbl = augment_batch(imgs, lbls, _gen(11), cfg)
    p = _sample_params(torch.rand((8, 2), generator=_gen(11)), 32, 48, cfg)
    img, lbl = _warp_batch(imgs, lbls, p.scale, p.oy, p.ox, p.flip, cfg.crop,
                           255)
    img = _color_jitter(img, p.brightness, p.contrast, p.saturation, p.hue,
                        enable_hue=True)
    want = (img - torch.tensor(cfg.mean)) / torch.tensor(cfg.std)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got_lbl, lbl, rtol=0, atol=0)


def test_sampling_ranges():
    """The laws of AugmentConfig's draw over 4096 images of 1024x2048 at
    crop 768x768: each factor uniform on its range (mean within 0.03 of
    the centre), flips at their rate, offsets uniform in
    [0, scaled − crop], centred where the scaled image is smaller."""
    n, h, w = 4096, 1024, 2048
    cfg = AugmentConfig(hue=0.1)
    p = _sample_params(torch.rand((8, n), generator=_gen(5)), h, w, cfg)
    ch, cw = cfg.crop
    for v, lo, hi in ((p.scale, 0.5, 2.0), (p.brightness, 0.75, 1.25),
                      (p.contrast, 0.75, 1.25), (p.saturation, 0.75, 1.25),
                      (p.hue, -0.1, 0.1)):
        assert lo <= float(v.min()) and float(v.max()) <= hi
        assert abs(float(v.mean()) - (lo + hi) / 2) < 0.03 * (hi - lo)
        assert float(v.std()) == pytest.approx((hi - lo) / 12 ** 0.5,
                                               rel=0.05)
    assert abs(float(p.flip.float().mean()) - 0.5) < 0.03
    for off, size, crop in ((p.oy, h, ch), (p.ox, w, cw)):
        scaled = p.scale * size
        big = scaled >= crop
        assert bool((off[big] >= 0).all())
        assert bool((off[big] <= scaled[big] - crop + 1e-3).all())
        frac = off[big] / (scaled[big] - crop).clamp(min=1e-6)
        assert abs(float(frac.mean()) - 0.5) < 0.03
        torch.testing.assert_close(off[~big], (scaled[~big] - crop) / 2)
    assert float(_sample_params(torch.rand((8, 64), generator=_gen(6)), h, w,
                                AugmentConfig()).hue.abs().max()) == 0.0
