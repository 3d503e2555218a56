"""PyTorch port, the schedule of K1's backward kernel
(`csrc/resize_ce.cu::resize_ce_bwd_mma`) emulated on the CPU from the
host's tables (`ops/resize_ce.py::_mma_schedule`), against the plain
version `resize_ce_reference_backward`.

The emulation follows the kernel's order: the tables read as the kernel
reads them (`mma_tables`), A unpacked from its mma fragments; per span the
staged cotangent (the span's output columns, zero past them), per 16-column
tile the banded product over the tile's k range; dw rounded to bf16; per
band of 8 low-res rows the walk over the output rows that touch it with a
sliding pair of float32 accumulators, a finished row written if it lies in
the band and dropped if it is a neighbour's, the band's untouched rows
written as zeros.

Tolerances: each float32 stage (the W pass before its bf16 rounding, the H
pass from the same bf16 dw) within 1e-6 of its scale of the plain version's
transposed pass: only the order of the float32 sums differs. The whole
d(logits) within two bf16 steps of its scale (2^-7), as the kernel is held
on the card: a float32 sum in another order can round dw to the
neighbouring bf16 value."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_semantic_segmentation_tpu_torch.ops import resize_ce as rce

torch.set_num_threads(2)

BAND = 8            # low-res rows of a backward band (csrc: BWD_ROWS)
STAGE_TOL = 1e-6    # of scale, each float32 stage
D_TOL = 2.0 ** -7   # of scale, d(logits) in bf16


def _read_tail(tail, w, js):
    """The tables as csrc/resize_ce.cu::mma_tables reads them (the tail
    starts the table here, so the fragments' padding counts from 0)."""
    nt, ns = -(-w // 16), -(-w // js)
    it = iter(np.split(tail[:3 * nt + 4 * ns], np.cumsum(
        [nt, nt, nt, ns, ns, ns])))
    k0, ks, foff, oc0, oc1, tlo, thi = (next(it) for _ in range(7))
    start = 3 * nt + 4 * ns
    start += -start % 4
    words = tail[start:].view(np.uint32)
    return k0, ks, foff, oc0, oc1, tlo, thi, words


def _unpack(words, ks):
    """A (16, 16·ks) float32 from mma.sync.m16n8k16's A fragments: lane l
    holds rows l//4 and l//4 + 8, columns 2(l%4) + {0,1} and + 8."""
    a = np.zeros((16, 16 * ks), np.float32)
    fr = words.reshape(ks, 32, 4)
    for s in range(ks):
        for lane in range(32):
            g, q = lane // 4, 16 * s + 2 * (lane % 4)
            for r, (m, k) in enumerate(((g, q), (g + 8, q), (g, q + 8),
                                        (g + 8, q + 8))):
                word = int(fr[s, lane, r])
                for half, kk in ((word & 0xFFFF, k), (word >> 16, k + 1)):
                    a[m, kk] = np.array([half << 16], np.uint32).view(
                        np.float32)[0]
    return a


def _cotangent(logits, labels, cw, logz, scale, ac):
    """d = bf16(gw·(exp(y − logz) − onehot)), float32 (N,OH,OW,C)."""
    oh, ow, c = labels.shape[1], labels.shape[2], logits.shape[-1]
    y = rce._upsampled(logits, oh, ow, ac)
    valid, safe, wv = rce._label_weights(labels, cw)
    p = torch.exp(y - logz.float().unsqueeze(-1))
    onehot = F.one_hot(safe, c).float() * valid.unsqueeze(-1)
    return ((wv * scale).unsqueeze(-1) * (p - onehot)).to(
        torch.bfloat16).float()


def _w_pass(d, w, ac, span_tiles):
    """The transposed W pass as the kernel's warps form it: float32
    (N,OH,w,C) before the bf16 rounding."""
    n, oh, ow, c = d.shape
    sched = rce._mma_schedule(w, ow, ac, span_tiles)
    k0, ks, foff, oc0, oc1, _, _, words = _read_tail(sched.tail, w, sched.js)
    dw = torch.full((n, oh, w, c), float("nan"))
    for s in range(len(oc0)):
        staged = torch.zeros((n, oh, sched.ocmax, c))
        staged[:, :, :oc1[s] - oc0[s]] = d[:, :, oc0[s]:oc1[s]]
        for t in range(s * span_tiles, min((s + 1) * span_tiles, len(k0))):
            ncol = min(16, w - 16 * t)
            if ks[t] == 0:
                dw[:, :, 16 * t:16 * t + ncol] = 0.0
                continue
            a = torch.from_numpy(_unpack(
                words[foff[t]:foff[t] + 128 * ks[t]], int(ks[t])))
            kb = int(k0[t] - oc0[s])
            b = staged[:, :, kb:kb + 16 * int(ks[t])]
            dw[:, :, 16 * t:16 * t + ncol] = torch.einsum(
                "mk,nokc->nomc", a, b)[:, :, :ncol]
    return dw


def _h_pass(dwb, h, ac):
    """The transposed H pass as the kernel's bands walk it: float32
    (N,h,w,C)."""
    n, oh, w, c = dwb.shape
    rows = rce._taps(h, oh, ac)
    first, last = rce._touching(rows, h)
    band_o0, band_o1 = rce._ranges(first, last, h, BAND)
    dx = torch.full((n, h, w, c), float("nan"))
    writes = np.zeros(h, np.int64)
    for band in range(len(band_o0)):
        r0, r_end = BAND * band, min(BAND * band + BAND, h)
        o_begin, o_end = int(band_o0[band]), int(band_o1[band])
        state = dict(R=int(rows.lo[o_begin]) if o_begin < o_end else r0,
                     next=r0)
        zero = torch.zeros((n, w, c))
        cur, nxt = zero.clone(), zero.clone()

        def flush(row, v):
            if not r0 <= row < r_end:
                return
            for rr in range(state["next"], row):
                dx[:, rr] = 0.0
                writes[rr] += 1
            dx[:, row] = v
            writes[row] += 1
            state["next"] = row + 1

        for o in range(o_begin, o_end):
            hl, hh = int(rows.lo[o]), int(rows.hi[o])
            a, b = float(rows.wlo[o]), float(rows.whi[o])
            while state["R"] < hl:
                flush(state["R"], cur)
                cur, nxt = nxt, zero.clone()
                state["R"] += 1
            cur = cur + a * dwb[:, o]
            if b != 0.0:
                if hh == state["R"]:
                    cur = cur + b * dwb[:, o]
                else:
                    nxt = nxt + b * dwb[:, o]
        flush(state["R"], cur)
        if state["R"] + 1 < h:
            flush(state["R"] + 1, nxt)
        for rr in range(state["next"], r_end):
            dx[:, rr] = 0.0
            writes[rr] += 1
    assert (writes == 1).all(), f"rows written {writes.tolist()}"
    return dx


def _close(got, want, tol):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"err {err:.3g} of scale {scale:.3g}"


# (n, h, w, c, oh, ow, align_corners, span tiles): x8 with 3 spans and 3
# bands, both ragged; x4; non-integer ratios both ways; C of 3, 19 and 66;
# a downsampling case (low-res rows and columns no output touches); one
# tile a span
CASES = [(2, 19, 70, 19, 152, 560, False, 2),
         (1, 19, 40, 19, 152, 320, True, 2),
         (1, 12, 40, 3, 48, 160, True, 2),
         (2, 12, 36, 3, 48, 144, False, 1),
         (1, 12, 20, 19, 100, 170, True, 2),
         (1, 13, 37, 66, 104, 296, False, 2),
         (1, 13, 37, 66, 90, 250, True, 1),
         (1, 20, 50, 19, 12, 30, False, 2)]


@pytest.mark.parametrize("n,h,w,c,oh,ow,ac,span_tiles", CASES)
def test_mma_schedule_matches_plain_backward(n, h, w, c, oh, ow, ac,
                                             span_tiles):
    rng = np.random.default_rng(h * 1000 + w)
    logits = torch.from_numpy((rng.normal(size=(n, h, w, c)) * 2).astype(
        np.float32)).to(torch.bfloat16)
    lab = rng.integers(0, c, (n, oh, ow))
    lab[:, :3, :7] = 255
    labels = torch.from_numpy(lab.astype(np.uint8))
    cw = torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32))
    _, s2, logz = rce.resize_ce_reference(logits, labels, cw, ac)
    scale = torch.tensor(0.7) / s2

    d = _cotangent(logits, labels, cw, logz, scale, ac)
    cols = rce._device_taps(w, ow, ac, "cpu")
    rows = rce._device_taps(h, oh, ac, "cpu")
    dw = _w_pass(d, w, ac, span_tiles)
    _close(dw, rce._resize_transposed(d, 2, cols, w), STAGE_TOL)
    dwb = dw.to(torch.bfloat16).float()
    dx = _h_pass(dwb, h, ac)
    _close(dx, rce._resize_transposed(dwb, 1, rows, h), STAGE_TOL)
    want = rce.resize_ce_reference_backward(logits, labels, cw, logz, scale,
                                            ac)
    _close(dx.to(torch.bfloat16).float(), want.float(), D_TOL)


def test_a_fragments_hold_the_bf16_taps():
    """Each tile's A, unpacked, is the bf16 interpolation matrix's block:
    every nonzero entry a bf16 tap, each output column's taps summing to
    its row of the matrix."""
    w, ow = 37, 296
    sched = rce._mma_schedule(w, ow, False, 2)
    m = torch.from_numpy(rce._interp_matrix(w, ow, False)).to(
        torch.bfloat16).float().numpy()                     # (ow, w)
    k0, ks, foff, *_, words = _read_tail(sched.tail, w, sched.js)
    for t in range(len(k0)):
        a = _unpack(words[foff[t]:foff[t] + 128 * ks[t]], int(ks[t]))
        ncol = min(16, w - 16 * t)
        q = np.arange(k0[t], k0[t] + 16 * ks[t])
        want = np.zeros_like(a)
        inside = q < ow
        want[:ncol, inside] = m[q[inside], 16 * t:16 * t + ncol].T
        np.testing.assert_array_equal(a, want)
