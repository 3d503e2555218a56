"""Fused ×k bilinear upsample + class-weighted cross-entropy, forward and
backward, with its Hopper kernels.

`resize_cross_entropy(logits, labels, class_weights)` is the loss of the
bf16 low-res logits (N,h,w,C) bilinearly upsampled to the label grid
(N,OH,OW), at the rounding points of the JAX package's Pallas kernel
(`ops/pallas_resize_ce.py`):

- the interpolation weights are `_interp_matrix`'s, rounded to bf16;
- the H pass in float32, rounded to bf16; the W pass in float32, clipped to
  ±80 (a direct-sum logsumexp needs no max pass below that);
- `logz = log Σ_c exp(y)`; a pixel weighs `cw[label]` for a label in
  [0, C) and 0 otherwise, so `ignore_index` (any value outside [0, C))
  needs no branch; loss = Σ w·(logz − y_label) / max(Σ w, 1e−12);
- logz is kept in bf16 as the backward's residual;
- backward: `d = bf16(w·g/S₂·(exp(y − logz) − onehot))`, the transposed W
  pass rounded to bf16, the transposed H pass accumulated in float32,
  d(logits) in the logits' dtype. Class weights get no gradient.

`per_pixel_resize_ce(logits, labels)` is the per-pixel variant (K3, the
JAX package's `per_pixel_resize_ce`, behind OHEM): the float32 loss map
(N,OH,OW), `logz − y_label` at a label in [0, C) and 0 elsewhere, without
class weights. Its backward takes a float32 cotangent map `ct` in place of
`cw[label]·g/S₂`: the per-pixel weight is `valid·ct`, which re-zeros
ignored pixels. Everything else, the taps and the rounding points, is K1's.

`resize_ce_forward`, `resize_ce_backward`, `resize_ce_map_forward` and
`resize_ce_map_backward` launch the CUDA kernels (`csrc/resize_ce.cu`) for
tensors on the card and run the plain PyTorch versions for tensors on the
CPU. On the card the full-resolution logits never reach device memory.
"""

from __future__ import annotations

import ctypes
import functools
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from torch_semantic_segmentation_tpu_torch import kernels
from torch_semantic_segmentation_tpu_torch.ops.upsample import _interp_matrix

_CLIP = 80.0
_LABEL_KINDS = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}


class _Taps(tp.NamedTuple):
    lo: np.ndarray    # (out,) int32: first source index
    hi: np.ndarray    # (out,) int32: second source index (= lo for one tap)
    wlo: np.ndarray   # (out,) float32, a bf16 value
    whi: np.ndarray   # (out,) float32, a bf16 value (0 for one tap)


@functools.lru_cache(maxsize=None)
def _taps(in_size: int, out_size: int, align_corners: bool) -> _Taps:
    """The nonzero entries of each row of the bf16-rounded interpolation
    matrix: at most two, which the bilinear rule guarantees."""
    m = torch.from_numpy(_interp_matrix(in_size, out_size, align_corners))
    m = m.to(torch.bfloat16).float().numpy()
    nz = m != 0
    if int(nz.sum(axis=1).max()) > 2:
        raise ValueError("a bilinear interpolation row has more than two taps")
    lo = nz.argmax(axis=1)
    hi = in_size - 1 - nz[:, ::-1].argmax(axis=1)
    rows = np.arange(out_size)
    whi = np.where(hi != lo, m[rows, hi], 0.0)
    return _Taps(lo.astype(np.int32), hi.astype(np.int32),
                 m[rows, lo].astype(np.float32), whi.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _device_taps(in_size: int, out_size: int, align_corners: bool,
                 device: str):
    t = _taps(in_size, out_size, align_corners)
    return tuple(torch.from_numpy(a).to(device) for a in t)


def _resize(x: torch.Tensor, dim: int, taps) -> torch.Tensor:
    """One bilinear pass along `dim` in float32: two taps an output, so the
    sum of two exact bf16 products rounds once, as the matrix product does."""
    lo, hi, wlo, whi = taps
    shape = [1] * x.dim()
    shape[dim] = -1
    return (x.index_select(dim, lo.long()) * wlo.reshape(shape)
            + x.index_select(dim, hi.long()) * whi.reshape(shape))


def _resize_transposed(g: torch.Tensor, dim: int, taps, size: int
                       ) -> torch.Tensor:
    """The transpose of `_resize`: scatter-add along `dim`, in float32."""
    lo, hi, wlo, whi = taps
    shape = [1] * g.dim()
    shape[dim] = -1
    out_shape = list(g.shape)
    out_shape[dim] = size
    out = torch.zeros(out_shape, dtype=torch.float32, device=g.device)
    out.index_add_(dim, lo.long(), g * wlo.reshape(shape))
    return out.index_add_(dim, hi.long(), g * whi.reshape(shape))


def _upsampled(logits: torch.Tensor, oh: int, ow: int, align_corners: bool
               ) -> torch.Tensor:
    """The clipped full-resolution logits (N,OH,OW,C), float32."""
    n, h, w, c = logits.shape
    dev = str(logits.device)
    rows = _device_taps(h, oh, align_corners, dev)
    cols = _device_taps(w, ow, align_corners, dev)
    t = _resize(logits.float(), 1, rows).to(torch.bfloat16).float()
    return _resize(t, 2, cols).clamp(-_CLIP, _CLIP)


def _valid_labels(labels: torch.Tensor, c: int):
    """(valid mask: the label lies in [0, C); class index, 0 where
    invalid)."""
    lab = labels.long()
    valid = (lab >= 0) & (lab < c)
    return valid, torch.where(valid, lab, 0)


def _label_weights(labels: torch.Tensor, cw: torch.Tensor):
    """(valid mask, class index with 0 where invalid, pixel weight)."""
    valid, safe = _valid_labels(labels, cw.shape[0])
    return valid, safe, torch.where(valid, cw.float()[safe], 0.0)


def resize_ce_reference(logits, labels, cw, align_corners: bool = False):
    """Plain PyTorch forward: (loss, S₂ = max(Σ w, 1e−12), logz in bf16)."""
    oh, ow = labels.shape[1], labels.shape[2]
    y = _upsampled(logits, oh, ow, align_corners)
    logz = torch.log(torch.exp(y).sum(dim=-1))
    _, safe, wv = _label_weights(labels, cw)
    tl = y.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    s2 = torch.clamp(wv.sum(), min=1e-12)
    return (wv * (logz - tl)).sum() / s2, s2, logz.to(torch.bfloat16)


def resize_ce_reference_backward(logits, labels, cw, logz, scale,
                                 align_corners: bool = False):
    """Plain PyTorch backward: d(logits) in the logits' dtype, for
    `scale` = g / S₂ (a float32 tensor)."""
    _, _, wv = _label_weights(labels, cw)
    return _backward_from(logits, labels, logz, wv * scale.float().reshape(()),
                          align_corners)


def resize_ce_map_reference(logits, labels, align_corners: bool = False):
    """Plain PyTorch forward of the per-pixel variant: (loss map (N,OH,OW)
    float32, 0 where the label lies outside [0, C); logz in bf16)."""
    oh, ow = labels.shape[1], labels.shape[2]
    y = _upsampled(logits, oh, ow, align_corners)
    logz = torch.log(torch.exp(y).sum(dim=-1))
    valid, safe = _valid_labels(labels, logits.shape[-1])
    tl = y.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    return torch.where(valid, logz - tl, 0.0), logz.to(torch.bfloat16)


def resize_ce_map_reference_backward(logits, labels, logz, ct,
                                     align_corners: bool = False):
    """Plain PyTorch backward of the per-pixel variant: d(logits) in the
    logits' dtype from the cotangent map `ct` (N,OH,OW)."""
    valid, _ = _valid_labels(labels, logits.shape[-1])
    return _backward_from(logits, labels, logz,
                          torch.where(valid, ct.float(), 0.0), align_corners)


def _backward_from(logits, labels, logz, gw, align_corners: bool):
    """d(logits) for the per-pixel weight `gw` (N,OH,OW) float32 of the
    cotangent `gw·(softmax(y) − onehot)`."""
    n, h, w, c = logits.shape
    oh, ow = labels.shape[1], labels.shape[2]
    y = _upsampled(logits, oh, ow, align_corners)
    p = torch.exp(y - logz.float().unsqueeze(-1))
    valid, safe = _valid_labels(labels, c)
    onehot = F.one_hot(safe, c).float() * valid.unsqueeze(-1)
    d = (gw.unsqueeze(-1) * (p - onehot)).to(torch.bfloat16).float()
    dev = str(logits.device)
    dw = _resize_transposed(d, 2, _device_taps(w, ow, align_corners, dev), w)
    dw = dw.to(torch.bfloat16).float()
    dx = _resize_transposed(dw, 1, _device_taps(h, oh, align_corners, dev), h)
    return dx.to(logits.dtype)


def _library() -> ctypes.CDLL:
    lib = kernels.load("resize_ce")
    if not getattr(lib, "_typed", False):
        p, i, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        for name in ("resize_ce_fwd_rows", "resize_ce_bwd_rows"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        lib.resize_ce_fwd_span.argtypes = [i]
        lib.resize_ce_fwd_span.restype = i
        for name in ("resize_ce_bwd_span_tiles",
                     "resize_ce_map_bwd_span_tiles"):
            getattr(lib, name).argtypes = [i, i, i]
            getattr(lib, name).restype = i
        lib.resize_ce_bwd_mma_smem.argtypes = [i, i, i]
        lib.resize_ce_bwd_mma_smem.restype = z
        lib.resize_ce_map_bwd_smem.argtypes = [i, i, i]
        lib.resize_ce_map_bwd_smem.restype = z
        lib.resize_ce_fwd_smem.argtypes = [i, i]
        lib.resize_ce_fwd_smem.restype = z
        lib.resize_ce_smem_limit.argtypes = []
        lib.resize_ce_smem_limit.restype = z
        lib.resize_ce_forward.argtypes = [p, p, i, p, p, p, p, p] + [i] * 8 + [p]
        lib.resize_ce_forward.restype = i
        lib.resize_ce_backward.argtypes = [p, p, i, p, p, p, p, p, p] + [i] * 9 + [p]
        lib.resize_ce_backward.restype = i
        lib.resize_ce_map_forward.argtypes = [p, p, i, p, p, p, p] + [i] * 8 + [p]
        lib.resize_ce_map_forward.restype = i
        lib.resize_ce_map_backward.argtypes = ([p, p, i, p, p, p, p, p, p, p]
                                               + [i] * 9 + [p])
        lib.resize_ce_map_backward.restype = i
        lib.resize_ce_error_string.argtypes = [i]
        lib.resize_ce_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _touching(taps: _Taps, in_size: int) -> tuple[np.ndarray, np.ndarray]:
    """For each source index, the range [first, last + 1) of the outputs
    whose taps read it ([0, 0) for none)."""
    first = np.full(in_size, np.iinfo(np.int32).max, np.int64)
    last = np.full(in_size, -1, np.int64)
    out = np.arange(len(taps.lo))
    for idx in (taps.lo, taps.hi):
        np.minimum.at(first, idx, out)
        np.maximum.at(last, idx, out)
    none = last < 0
    first[none], last[none] = 0, -1
    return first, last + 1


def _ranges(first, last, size: int, block: int):
    """Per block of `block` consecutive indices: the union [lo, hi) of their
    ranges ([0, 0) for none)."""
    lo, hi = [], []
    for s in range(0, size, block):
        f, e = first[s:s + block], last[s:s + block]
        used = e > f
        lo.append(int(f[used].min()) if used.any() else 0)
        hi.append(int(e[used].max()) if used.any() else 0)
    return np.array(lo, np.int64), np.array(hi, np.int64)


def _source_span(taps: _Taps, lo: np.ndarray, hi: np.ndarray):
    """Per output range [lo, hi): the source indices it reads, [tlo, thi]."""
    tlo = [int(taps.lo[a:b].min()) if b > a else 0 for a, b in zip(lo, hi)]
    thi = [int(taps.hi[a:b].max()) if b > a else -1 for a, b in zip(lo, hi)]
    return np.array(tlo, np.int64), np.array(thi, np.int64)


_TILE = 16   # low-res columns of an mma tile (the m of m16n8k16)


def _fragments(a: np.ndarray) -> np.ndarray:
    """A (16, 16·ks) of bf16 values as mma.sync.m16n8k16's A fragments:
    (ks, 32 lanes, 4) uint32, two bf16 a word, the lower k in the low half.
    Lane l holds rows g = l // 4 and g + 8, columns 2(l % 4) + {0, 1} and
    the same + 8, of each 16-column k step."""
    ks = a.shape[1] // 16
    lane = np.arange(32)
    g, q = lane // 4, 2 * (lane % 4)
    rows = np.stack([g, g + 8, g, g + 8], axis=1)             # (32, 4)
    cols = np.stack([q, q, q + 8, q + 8], axis=1)
    k = 16 * np.arange(ks)[:, None, None] + cols[None]        # (ks, 32, 4)
    bits = a.astype(np.float32).view(np.uint32) >> 16
    lo = bits[rows[None], k]
    hi = bits[rows[None], k + 1]
    return (lo | (hi << 16)).astype(np.uint32)


class _MmaSchedule(tp.NamedTuple):
    tail: np.ndarray      # int32, appended to the int table (mma_tables)
    js: int               # low-res columns of a span (16 · its tiles)
    tmax: int             # low-res columns a span's W taps read, at most
    ocmax: int            # rows of the staged cotangent: a span's output
                          # columns and every tile's k range


def _mma_schedule(w: int, ow: int, align_corners: bool, span_tiles: int,
                  head: int = 0) -> _MmaSchedule:
    """The tables of a backward's W pass on the tensor cores
    (csrc/resize_ce.cu::mma_tables: K1's, and phase A of K3's) for spans of
    `span_tiles` 16-wide column tiles, after `head` ints of the table.

    Per tile: the output columns [k0, k1) that touch its 16 low-res
    columns, rounded up to k steps of 16, and A, the tile's dense block of
    the transposed bf16 interpolation matrix (A[m, k] = the tap of output
    column k0 + k on low-res column 16·tile + m), as mma fragments. Per
    span: its output columns and the low-res columns their taps read."""
    cols = _taps(w, ow, align_corners)
    first, last = _touching(cols, w)
    nt = -(-w // _TILE)
    k0, k1 = _ranges(first, last, w, _TILE)
    ks = np.where(k1 > k0, -(-(k1 - k0) // 16), 0)
    frags, offs, off = [], [], 0
    for t in range(nt):
        a = np.zeros((_TILE, 16 * ks[t]), np.float32)
        q = np.arange(k0[t], k0[t] + 16 * ks[t])
        q = q[q < ow]
        for idx, wt in ((cols.lo, cols.wlo), (cols.hi, cols.whi)):
            m = idx[q] - _TILE * t
            inside = (m >= 0) & (m < _TILE) & (wt[q] != 0)
            np.add.at(a, (m[inside], q[inside] - k0[t]), wt[q][inside])
        frags.append(_fragments(a))
        offs.append(off)
        off += frags[-1].size
    js = _TILE * span_tiles
    oc0, oc1 = _ranges(first, last, w, js)
    tlo, thi = _source_span(cols, oc0, oc1)
    used = np.nonzero(ks)[0]
    ocmax = max([1, int((oc1 - oc0).max())]
                + [int(k0[t] - oc0[t // span_tiles] + 16 * ks[t])
                   for t in used])
    tmax = max(int((thi - tlo).max()) + 1, 1)
    index = np.concatenate([k0, ks, offs, oc0, oc1, tlo, thi])
    pad = np.zeros(-(head + len(index)) % 4, np.int32)
    words = (np.concatenate([f.reshape(-1) for f in frags])
             if off else np.zeros(0, np.uint32))
    tail = np.concatenate([index.astype(np.int32), pad,
                           words.view(np.int32)])
    return _MmaSchedule(tail, js, tmax, ocmax)


class _Plan(tp.NamedTuple):
    itab: np.ndarray   # int32 tables, in the order of csrc/resize_ce.cu::tables
    ftab: np.ndarray   # float32 tables
    tmax_fwd: int
    fwd_blocks: int
    mma_tmax: int      # K1's backward: low-res columns a span reads
    mma_ocmax: int     # and rows of its staged cotangent
    wtab: np.ndarray   # K3's backward, phase A: its int table (mma_tables)
    map_tmax: int      # and the same two of its spans
    map_ocmax: int


@functools.lru_cache(maxsize=None)
def _plan(h: int, w: int, oh: int, ow: int, c: int,
          align_corners: bool) -> _Plan:
    """The launch geometry and the interpolation tables of the kernels."""
    lib = _library()
    fwd_rows, fwd_span = lib.resize_ce_fwd_rows(), lib.resize_ce_fwd_span(ow)
    bwd_rows = lib.resize_ce_bwd_rows()
    limit = lib.resize_ce_smem_limit()
    rows, cols = _taps(h, oh, align_corners), _taps(w, ow, align_corners)
    # forward: the low-res columns each span of output columns reads
    f_lo = np.arange(0, ow, fwd_span)
    f_tlo, f_thi = _source_span(cols, f_lo, np.minimum(f_lo + fwd_span, ow))
    tmax_fwd = int((f_thi - f_tlo).max()) + 1
    if lib.resize_ce_fwd_smem(c, tmax_fwd) > limit:
        raise ValueError(f"resize_ce kernel: C={c} with {tmax_fwd} source "
                         "columns a block exceeds the shared memory")
    # backward: the output rows that touch each low-res row (K3's phase B)
    # and each band of them (K1)
    r_first, r_last = _touching(rows, h)
    band_o0, band_o1 = _ranges(r_first, r_last, h, bwd_rows)
    itab = np.concatenate([rows.lo, rows.hi, cols.lo, cols.hi, f_tlo, f_thi,
                           band_o0, band_o1, r_first, r_last]
                          ).astype(np.int32)
    # K1's backward walks the output rows in order with a sliding pair of
    # low-res rows: their taps must ascend and span at most two rows
    if np.any(np.diff(rows.lo) < 0) or np.any(rows.hi - rows.lo > 1):
        raise ValueError("resize_ce kernel: the row taps do not ascend")
    mma = _mma_schedule(w, ow, align_corners,
                        lib.resize_ce_bwd_span_tiles(c, w, ow), len(itab))
    if lib.resize_ce_bwd_mma_smem(c, mma.tmax, mma.ocmax) > limit:
        raise ValueError(f"resize_ce kernel: C={c} at {w} -> {ow} columns "
                         "exceeds the backward block's shared memory")
    itab = np.concatenate([itab, mma.tail])
    wmap = _mma_schedule(w, ow, align_corners,
                         lib.resize_ce_map_bwd_span_tiles(c, w, ow))
    if lib.resize_ce_map_bwd_smem(c, wmap.tmax, wmap.ocmax) > limit:
        raise ValueError(f"resize_ce kernel: C={c} at {w} -> {ow} columns "
                         "exceeds the map backward block's shared memory")
    ftab = np.concatenate([rows.wlo, rows.whi, cols.wlo, cols.whi]
                          ).astype(np.float32)
    fwd_blocks = len(f_lo) * -(-oh // fwd_rows)
    return _Plan(itab, ftab, tmax_fwd, fwd_blocks, mma.tmax, mma.ocmax,
                 wmap.tail, wmap.tmax, wmap.ocmax)


@functools.lru_cache(maxsize=None)
def _device_tables(h: int, w: int, oh: int, ow: int, c: int,
                   align_corners: bool, device: str):
    plan = _plan(h, w, oh, ow, c, align_corners)
    return tuple(torch.from_numpy(t).to(device)
                 for t in (plan.itab, plan.ftab, plan.wtab))


def _check_cuda_inputs(logits, labels, cw=None):
    if logits.dtype != torch.bfloat16:
        raise TypeError(f"resize_ce kernel takes bfloat16 logits, got "
                        f"{logits.dtype}")
    if labels.dtype not in _LABEL_KINDS:
        raise TypeError(f"resize_ce kernel takes uint8, int32 or int64 "
                        f"labels, got {labels.dtype}")
    if logits.dim() != 4 or labels.dim() != 3:
        raise ValueError("resize_ce kernel takes (N,h,w,C) logits and "
                         "(N,OH,OW) labels")
    if not (logits.is_contiguous() and labels.is_contiguous()):
        raise ValueError("resize_ce kernel takes contiguous tensors")
    if labels.shape[0] != logits.shape[0]:
        raise ValueError(f"resize_ce kernel: {labels.shape[0]} label maps "
                         f"for {logits.shape[0]} logit maps")
    if cw is not None and (tuple(cw.shape) != (logits.shape[-1],)
                           or cw.dtype != torch.float32):
        raise ValueError(f"resize_ce kernel: class weights {tuple(cw.shape)} "
                         f"{cw.dtype}, expected ({logits.shape[-1]},) float32")
    for t in (labels, cw):
        if t is not None and t.device != logits.device:
            raise ValueError("resize_ce kernel: all tensors must be on "
                             f"{logits.device}, got one on {t.device}")


def _check_map(t: torch.Tensor, shape, dtype, device, what: str):
    if (tuple(t.shape) != shape or t.dtype != dtype
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"resize_ce backward: {what} must be a contiguous "
                         f"{dtype} {shape} tensor on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"resize_ce {what} kernel launch failed: "
                           + lib.resize_ce_error_string(err).decode())


def resize_ce_forward(logits: torch.Tensor, labels: torch.Tensor,
                      cw: torch.Tensor, align_corners: bool = False):
    """(loss, S₂, logz): the kernel on the card, `resize_ce_reference` on
    the CPU."""
    if logits.device.type == "cpu":
        return resize_ce_reference(logits, labels, cw, align_corners)
    if logits.device.type != "cuda":
        raise ValueError(f"resize_ce: no kernel for device {logits.device}")
    _check_cuda_inputs(logits, labels, cw)
    n, h, w, c = logits.shape
    oh, ow = labels.shape[1], labels.shape[2]
    key = (h, w, oh, ow, c, bool(align_corners))
    plan = _plan(*key)
    itab, ftab, _ = _device_tables(*key, str(logits.device))
    partial = torch.empty((n * plan.fwd_blocks, 2), dtype=torch.float32,
                          device=logits.device)
    logz = torch.empty((n, oh, ow), dtype=torch.bfloat16, device=logits.device)
    lib = _library()
    _check(lib, lib.resize_ce_forward(
        logits.data_ptr(), labels.data_ptr(), _LABEL_KINDS[labels.dtype],
        cw.data_ptr(), itab.data_ptr(), ftab.data_ptr(), partial.data_ptr(),
        logz.data_ptr(), n, h, w, c, oh, ow, plan.tmax_fwd,
        logits.device.index or 0, _stream(logits)), "forward")
    resize_ce_forward.launches += 1
    kernels.check_finite("resize_ce forward", partial, logz)
    sums = partial.sum(dim=0)
    s2 = torch.clamp(sums[1], min=1e-12)
    return sums[0] / s2, s2, logz


resize_ce_forward.launches = 0


def resize_ce_backward(logits: torch.Tensor, labels: torch.Tensor,
                       cw: torch.Tensor, logz: torch.Tensor,
                       scale: torch.Tensor, align_corners: bool = False
                       ) -> torch.Tensor:
    """d(logits) for `scale` = g / S₂: the kernel on the card,
    `resize_ce_reference_backward` on the CPU."""
    if logits.device.type == "cpu":
        return resize_ce_reference_backward(logits, labels, cw, logz, scale,
                                            align_corners)
    if logits.device.type != "cuda":
        raise ValueError(f"resize_ce: no kernel for device {logits.device}")
    _check_cuda_inputs(logits, labels, cw)
    n, h, w, c = logits.shape
    oh, ow = labels.shape[1], labels.shape[2]
    _check_map(logz, (n, oh, ow), torch.bfloat16, logits.device, "logz")
    key = (h, w, oh, ow, c, bool(align_corners))
    plan = _plan(*key)
    itab, ftab, _ = _device_tables(*key, str(logits.device))
    scale = scale.to(device=logits.device, dtype=torch.float32).reshape(1)
    dx = torch.empty_like(logits)
    lib = _library()
    _check(lib, lib.resize_ce_backward(
        logits.data_ptr(), labels.data_ptr(), _LABEL_KINDS[labels.dtype],
        cw.data_ptr(), logz.data_ptr(), scale.data_ptr(), itab.data_ptr(),
        ftab.data_ptr(), dx.data_ptr(), n, h, w, c, oh, ow,
        plan.mma_tmax, plan.mma_ocmax, logits.device.index or 0,
        _stream(logits)), "backward")
    resize_ce_backward.launches += 1
    kernels.check_finite("resize_ce backward", dx)
    return dx


resize_ce_backward.launches = 0


def resize_ce_map_forward(logits: torch.Tensor, labels: torch.Tensor,
                          align_corners: bool = False):
    """(loss map, logz) of the per-pixel variant: the kernel on the card,
    `resize_ce_map_reference` on the CPU."""
    if logits.device.type == "cpu":
        return resize_ce_map_reference(logits, labels, align_corners)
    if logits.device.type != "cuda":
        raise ValueError(f"resize_ce: no kernel for device {logits.device}")
    _check_cuda_inputs(logits, labels)
    n, h, w, c = logits.shape
    oh, ow = labels.shape[1], labels.shape[2]
    key = (h, w, oh, ow, c, bool(align_corners))
    plan = _plan(*key)
    itab, ftab, _ = _device_tables(*key, str(logits.device))
    loss_map = torch.empty((n, oh, ow), dtype=torch.float32,
                           device=logits.device)
    logz = torch.empty((n, oh, ow), dtype=torch.bfloat16, device=logits.device)
    lib = _library()
    _check(lib, lib.resize_ce_map_forward(
        logits.data_ptr(), labels.data_ptr(), _LABEL_KINDS[labels.dtype],
        itab.data_ptr(), ftab.data_ptr(), loss_map.data_ptr(), logz.data_ptr(),
        n, h, w, c, oh, ow, plan.tmax_fwd, logits.device.index or 0,
        _stream(logits)), "map forward")
    resize_ce_map_forward.launches += 1
    kernels.check_finite("resize_ce map forward", loss_map, logz)
    return loss_map, logz


resize_ce_map_forward.launches = 0


def resize_ce_map_backward(logits: torch.Tensor, labels: torch.Tensor,
                           logz: torch.Tensor, ct: torch.Tensor,
                           align_corners: bool = False) -> torch.Tensor:
    """d(logits) of the per-pixel variant from the cotangent map `ct`: the
    kernel on the card, `resize_ce_map_reference_backward` on the CPU."""
    if logits.device.type == "cpu":
        return resize_ce_map_reference_backward(logits, labels, logz, ct,
                                                align_corners)
    if logits.device.type != "cuda":
        raise ValueError(f"resize_ce: no kernel for device {logits.device}")
    _check_cuda_inputs(logits, labels)
    n, h, w, c = logits.shape
    oh, ow = labels.shape[1], labels.shape[2]
    _check_map(logz, (n, oh, ow), torch.bfloat16, logits.device, "logz")
    _check_map(ct, (n, oh, ow), torch.float32, logits.device, "the cotangent")
    key = (h, w, oh, ow, c, bool(align_corners))
    plan = _plan(*key)
    itab, ftab, wtab = _device_tables(*key, str(logits.device))
    # phase A's transposed W pass, rounded to bf16, for phase B to sum
    dw = torch.empty((n, oh, w, c), dtype=torch.bfloat16, device=logits.device)
    dx = torch.empty_like(logits)
    lib = _library()
    _check(lib, lib.resize_ce_map_backward(
        logits.data_ptr(), labels.data_ptr(), _LABEL_KINDS[labels.dtype],
        logz.data_ptr(), ct.data_ptr(), itab.data_ptr(), ftab.data_ptr(),
        wtab.data_ptr(), dw.data_ptr(), dx.data_ptr(), n, h, w, c, oh, ow,
        plan.map_tmax, plan.map_ocmax, logits.device.index or 0,
        _stream(logits)), "map backward")
    resize_ce_map_backward.launches += 1
    kernels.check_finite("resize_ce map backward", dx)
    return dx


resize_ce_map_backward.launches = 0


class _ResizeCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, cw, align_corners):
        loss, s2, logz = resize_ce_forward(logits, labels, cw, align_corners)
        ctx.align_corners = align_corners
        ctx.save_for_backward(logits, labels, cw, s2, logz)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, cw, s2, logz = ctx.saved_tensors
        dx = resize_ce_backward(logits, labels, cw, logz, g.float() / s2,
                                ctx.align_corners)
        return dx, None, None, None


def resize_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         class_weights: torch.Tensor | None = None, *,
                         align_corners: bool = False) -> torch.Tensor:
    """The fused resize + CE loss, a float32 scalar. logits (N,h,w,C);
    labels (N,OH,OW) uint8, int32 or int64, read as they come; labels
    outside [0, C) weigh 0. Class weights are constants here (no
    gradient)."""
    c = logits.shape[-1]
    cw = (torch.ones(c, dtype=torch.float32, device=logits.device)
          if class_weights is None
          else torch.as_tensor(class_weights, dtype=torch.float32,
                               device=logits.device).detach().contiguous())
    return _ResizeCE.apply(logits.contiguous(), labels.contiguous(), cw,
                           bool(align_corners))


class _ResizeCEMap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, align_corners):
        loss_map, logz = resize_ce_map_forward(logits, labels, align_corners)
        ctx.align_corners = align_corners
        ctx.save_for_backward(logits, labels, logz)
        return loss_map

    @staticmethod
    def backward(ctx, ct):
        logits, labels, logz = ctx.saved_tensors
        dx = resize_ce_map_backward(logits, labels, logz,
                                    ct.float().contiguous(), ctx.align_corners)
        return dx, None, None


def per_pixel_resize_ce(logits: torch.Tensor, labels: torch.Tensor, *,
                        align_corners: bool = False) -> torch.Tensor:
    """The per-pixel fused resize + CE loss map (N,OH,OW) float32, 0 where
    the label lies outside [0, C). logits (N,h,w,C) bf16; labels (N,OH,OW)
    uint8, int32 or int64."""
    return _ResizeCEMap.apply(logits.contiguous(), labels.contiguous(),
                              bool(align_corners))
