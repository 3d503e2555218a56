"""Input transforms on the device (the JAX package's `data/transforms.py`):
the fused train-time augmentation and the eval-time normalisation, uint8
NHWC frames → normalised float.

`augment_batch` draws each image's scale, crop offset, flip and colour
jitter from one `torch.rand((8, N), generator=...)` on the images' device,
then warps, jitters and normalises, with static output shapes:

- scale → crop → flip is one separable inverse warp: each output row and
  column has a source coordinate under the drawn (scale, offset, flip), and
  the image is sampled there bilinearly, a 2-tap lerp along H and then
  along W with the clamped indices of the JAX package's 2-hot sampling
  matrices (the products of those matrices compute the same two-term
  sums); labels nearest, rounding half to even. Outside the scaled image
  the image is 0 (the mean after normalisation) and the label
  `ignore_index`;
- colour jitter in the order brightness, contrast, saturation (the
  contrast's gray mean a float32 reduction over the image), hue optional;
- mean/std normalisation, cast to `cfg.out_dtype`.

The JAX package warps in bf16 on the TPU (a choice for its matrix unit) and
in float32 elsewhere; the port warps in float32 on every device. The two
packages draw different random numbers from a seed (threefry against
Philox), so tests feed both the same per-image parameters. The TPU layout
option `pack` is not ported.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch

# ImageNet statistics, which the reference uses for Cityscapes
CITYSCAPES_MEAN = (0.485, 0.456, 0.406)
CITYSCAPES_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The reference's train-time pipeline: random scale, crop and flip,
    colour jitter, normalisation."""
    crop: tuple[int, int] = (768, 768)
    scale_range: tuple[float, float] = (0.5, 2.0)
    hflip_prob: float = 0.5
    brightness: float = 0.25
    contrast: float = 0.25
    saturation: float = 0.25
    hue: float = 0.0
    mean: tuple[float, float, float] = CITYSCAPES_MEAN
    std: tuple[float, float, float] = CITYSCAPES_STD
    ignore_index: int = 255
    out_dtype: tp.Any = torch.float32


def _lerp_taps(src: torch.Tensor, in_size: int):
    """(lo, hi, frac) of bilinear sampling at the float coordinates `src`:
    the two nonzero columns of a row of the JAX package's
    `_interp_matrix_rows`, clamped to [0, in_size − 1], and the weight of
    hi."""
    lo = torch.floor(src)
    lo_c = lo.clamp(0, in_size - 1).long()
    hi_c = (lo + 1).clamp(0, in_size - 1).long()
    return lo_c, hi_c, src - lo


def _warp_batch(images: torch.Tensor, labels: torch.Tensor,
                scale: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                flip: torch.Tensor, crop: tuple[int, int], ignore_index: int):
    """Warp (N,H,W,3) uint8 images and (N,H,W) labels to the crop size with
    per-image scale, offsets and flip (each of shape (N,)), in float32.
    Returns (images in [0, 1] (N,ch,cw,3) float32, labels (N,ch,cw)
    int32)."""
    n, h, w = images.shape[0], images.shape[1], images.shape[2]
    ch, cw = crop
    dev = images.device
    scale, oy, ox = scale.float(), oy.float(), ox.float()
    yi = torch.arange(ch, dtype=torch.float32, device=dev)
    src_y = (yi[None, :] + oy[:, None] + 0.5) / scale[:, None] - 0.5
    xi = torch.arange(cw, dtype=torch.float32, device=dev)
    xi = torch.where(flip[:, None], (cw - 1) - xi[None, :], xi[None, :])
    src_x = (xi + ox[:, None] + 0.5) / scale[:, None] - 0.5
    rows = torch.arange(n, device=dev)[:, None]

    # x[rows, idx] gathers idx (N, K) along dim 1. Rows, then columns
    # (through the (N, W, ch, 3) view), each w_lo·v_lo + w_hi·v_hi in
    # float32
    lo, hi, f = _lerp_taps(src_y, h)
    f = f[:, :, None, None]
    img = (images[rows, lo].float() * (1 - f)
           + images[rows, hi].float() * f)                  # (N, ch, W, 3)
    lo, hi, f = _lerp_taps(src_x, w)
    f = f[:, :, None, None]
    img_t = img.transpose(1, 2)
    img = img_t[rows, lo] * (1 - f) + img_t[rows, hi] * f  # (N, cw, ch, 3)
    img = img.transpose(1, 2).contiguous() / 255.0

    iy = torch.round(src_y).clamp(0, h - 1).long()
    ix = torch.round(src_x).clamp(0, w - 1).long()
    lbl = labels[rows, iy].transpose(1, 2)[rows, ix].transpose(1, 2)

    vy = (src_y >= -0.5) & (src_y <= h - 0.5)
    vx = (src_x >= -0.5) & (src_x <= w - 0.5)
    valid = vy[:, :, None] & vx[:, None, :]
    img = torch.where(valid[..., None], img, 0.0)
    lbl = torch.where(valid, lbl.to(torch.int32),
                      torch.tensor(ignore_index, dtype=torch.int32, device=dev))
    return img, lbl.contiguous()


def _rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    # ITU-R 601 luma (torchvision rgb_to_grayscale coefficients)
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]


def _color_jitter(img: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  s: torch.Tensor, hshift: torch.Tensor,
                  enable_hue: bool) -> torch.Tensor:
    """Brightness, contrast, saturation (and hue, a rotation in YIQ space)
    on (N,H,W,3) images in [0, 1], with per-image factors of shape (N,)."""
    b, c, s, hshift = (v.reshape(-1, 1, 1, 1).to(img.dtype)
                       for v in (b, c, s, hshift))
    img = torch.clamp(img * b, 0.0, 1.0)
    gray_mean = _rgb_to_gray(img).float().mean(dim=(1, 2, 3), keepdim=True)
    gray_mean = gray_mean.to(img.dtype)
    img = torch.clamp((img - gray_mean) * c + gray_mean, 0.0, 1.0)
    gray = _rgb_to_gray(img)
    img = torch.clamp((img - gray) * s + gray, 0.0, 1.0)
    if enable_hue:
        theta = hshift[..., 0] * 2.0 * math.pi
        cos_t, sin_t = torch.cos(theta), torch.sin(theta)
        r, g, bl = img[..., 0], img[..., 1], img[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * bl
        i = 0.596 * r - 0.274 * g - 0.322 * bl
        q = 0.211 * r - 0.523 * g + 0.312 * bl
        i, q = i * cos_t - q * sin_t, i * sin_t + q * cos_t
        r = y + 0.956 * i + 0.621 * q
        g = y - 0.272 * i - 0.647 * q
        bl = y - 1.106 * i + 1.703 * q
        img = torch.clamp(torch.stack([r, g, bl], dim=-1), 0.0, 1.0)
    return img


class _Params(tp.NamedTuple):
    """One image's draw, each of shape (N,)."""
    scale: torch.Tensor
    oy: torch.Tensor
    ox: torch.Tensor
    flip: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor


def _sample_params(u: torch.Tensor, h: int, w: int,
                   cfg: AugmentConfig) -> _Params:
    """Map the uniform draw u (8, N), row by row, to each image's
    parameters, as the JAX package's `augment_batch` maps its own."""
    ch, cw = cfg.crop
    smin, smax = cfg.scale_range
    scale = smin + u[0] * (smax - smin)
    # crop offset uniform in [0, max(scaled − crop, 0)] an axis, centred
    # when the scaled image is smaller than the crop
    oy = u[1] * torch.clamp(scale * h - ch, min=0.0)
    ox = u[2] * torch.clamp(scale * w - cw, min=0.0)
    oy = torch.where(scale * h < ch, (scale * h - ch) / 2.0, oy)
    ox = torch.where(scale * w < cw, (scale * w - cw) / 2.0, ox)
    return _Params(
        scale, oy, ox, u[3] < cfg.hflip_prob,
        1 - cfg.brightness + u[4] * (2 * cfg.brightness),
        1 - cfg.contrast + u[5] * (2 * cfg.contrast),
        1 - cfg.saturation + u[6] * (2 * cfg.saturation),
        -cfg.hue + u[7] * (2 * cfg.hue))


def augment_batch(images: torch.Tensor, labels: torch.Tensor,
                  generator: torch.Generator,
                  cfg: AugmentConfig = AugmentConfig()
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused train-time transform on the images' device: (N,H,W,3)
    uint8 images and (N,H,W) labels → (images (N,ch,cw,3) normalised in
    `cfg.out_dtype`, labels (N,ch,cw) int32). `generator` lies on the
    images' device; the same generator state gives the same batch."""
    n, h, w, _ = images.shape
    u = torch.rand((8, n), generator=generator, device=images.device)
    p = _sample_params(u, h, w, cfg)
    img, lbl = _warp_batch(images, labels, p.scale, p.oy, p.ox, p.flip,
                           cfg.crop, cfg.ignore_index)
    if cfg.brightness or cfg.contrast or cfg.saturation or cfg.hue:
        img = _color_jitter(img, p.brightness, p.contrast, p.saturation,
                            p.hue, enable_hue=cfg.hue > 0)
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=images.device)
    return ((img - mean) / std).to(cfg.out_dtype), lbl


def normalize_batch(images: torch.Tensor, *, mean=CITYSCAPES_MEAN,
                    std=CITYSCAPES_STD,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 → (x/255 − mean)/std in float32, cast to `out_dtype`, on the
    images' device."""
    x = images.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.tensor(std, dtype=torch.float32, device=images.device)
    return ((x - m) / s).to(out_dtype)
