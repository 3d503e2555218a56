"""PyTorch port, K3's backward (`ops.resize_ce.resize_ce_map_backward`) as
its two kernels compute it (`csrc/resize_ce.cu::resize_ce_map_bwd_w`, then
`resize_ce_map_bwd_h`), emulated on the CPU from the host's tables, against
the plain version `resize_ce_map_reference_backward`; and the variants of
`scripts/torch_resize_ce_probe.py`, each of which must patch only the
kernel it names.

Phase A, per output row: the cotangent bf16(valid·ct·(exp(y − logz) −
onehot)); per span of 16-column tiles the staged cotangent (the span's
output columns, zero past them), per tile the banded product over its k
range with A unpacked from `_mma_schedule`'s fragments; rounded to bf16
into the scratch dw. Phase B, per low-res row: the float32 sum
over the output rows that touch it (the ranges `_touching` gives the int
table), ascending, of the row tap times dw.

Tolerances as for K1's schedule (`tests/test_torch_resize_ce_bwd.py`):
each float32 stage within 1e-6 of its scale of the plain version's
transposed pass, since only the order of the float32 sums differs; the
whole d(logits) within two bf16 steps of its scale (2^-7), as the kernel
is held on the card."""

import ast
import difflib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_resize_ce_bwd import _w_pass
from torch_semantic_segmentation_tpu_torch.ops import resize_ce as rce

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CU = ROOT / "torch_semantic_segmentation_tpu_torch" / "csrc" / "resize_ce.cu"
PROBE = ROOT / "scripts" / "torch_resize_ce_probe.py"
STAGE_TOL = 1e-6    # of scale, each float32 stage
D_TOL = 2.0 ** -7   # of scale, d(logits) in bf16


def _cotangent(logits, labels, logz, ct, ac):
    """d = bf16(valid·ct·(exp(y − logz) − onehot)), float32 (N,OH,OW,C)."""
    oh, ow, c = labels.shape[1], labels.shape[2], logits.shape[-1]
    y = rce._upsampled(logits, oh, ow, ac)
    valid, safe = rce._valid_labels(labels, c)
    p = torch.exp(y - logz.float().unsqueeze(-1))
    onehot = F.one_hot(safe, c).float() * valid.unsqueeze(-1)
    gw = torch.where(valid, ct, 0.0)
    return (gw.unsqueeze(-1) * (p - onehot)).to(torch.bfloat16).float()


def _h_pass(dwb, h, ac):
    """Phase B: per low-res row i, the float32 sum over the output rows
    [first, last) that touch it, ascending, of its tap times dw."""
    n, oh, w, c = dwb.shape
    rows = rce._taps(h, oh, ac)
    first, last = rce._touching(rows, h)
    dx = torch.zeros((n, h, w, c))
    for i in range(h):
        for o in range(int(first[i]), int(last[i])):
            wt = (rows.wlo[o] if rows.lo[o] == i
                  else rows.whi[o] if rows.hi[o] == i else 0.0)
            dx[:, i] += float(wt) * dwb[:, o]
    # every output row that reads row i lies in its range
    for o in range(oh):
        for i in {int(rows.lo[o]), int(rows.hi[o])}:
            assert first[i] <= o < last[i]
    return dx


def _close(got, want, tol):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"err {err:.3g} of scale {scale:.3g}"


# (n, h, w, c, oh, ow, align_corners, labels, span tiles as
# csrc/resize_ce.cu::map_span_tiles chooses them): x16 ragged, C of 19, 66
# (three class groups) and 3, W under one tile; x16 over two spans (5
# tiles and 1); x8 with 5 tiles; a non-integer ratio; a downsampling case (rows
# and columns no output touches)
CASES = [(2, 6, 5, 19, 96, 80, False, "uint8", 1),
         (1, 7, 9, 66, 112, 144, True, "int32", 1),
         (1, 3, 2, 3, 48, 32, False, "int64", 1),
         (1, 4, 90, 19, 64, 1440, False, "int32", 5),
         (2, 19, 70, 19, 152, 560, False, "int32", 5),
         (1, 12, 20, 19, 100, 170, True, "uint8", 2),
         (1, 20, 50, 19, 12, 30, False, "int64", 4)]


@pytest.mark.parametrize("n,h,w,c,oh,ow,ac,label_dtype,span_tiles", CASES)
def test_two_phase_schedule_matches_plain_backward(n, h, w, c, oh, ow, ac,
                                                   label_dtype, span_tiles):
    rng = np.random.default_rng(h * 1000 + w + c)
    logits = torch.from_numpy((rng.normal(size=(n, h, w, c)) * 2).astype(
        np.float32)).to(torch.bfloat16)
    lab = rng.integers(0, c, (n, oh, ow))
    lab[:, :3, :7] = 255                         # ignored, with ct != 0
    if label_dtype != "uint8":
        lab[:, -2:, -5:] = -1
    labels = torch.from_numpy(lab.astype(label_dtype))
    ct = rng.normal(size=(n, oh, ow)).astype(np.float32)
    ct[:, oh // 2:oh // 2 + 2] = 0.0             # rows whose cotangent is 0
    ct = torch.from_numpy(ct)
    _, logz = rce.resize_ce_map_reference(logits, labels, ac)

    d = _cotangent(logits, labels, logz, ct, ac)
    cols = rce._device_taps(w, ow, ac, "cpu")
    rows = rce._device_taps(h, oh, ac, "cpu")
    dw = _w_pass(d, w, ac, span_tiles)
    _close(dw, rce._resize_transposed(d, 2, cols, w), STAGE_TOL)
    dwb = dw.to(torch.bfloat16).float()          # the scratch
    dx = _h_pass(dwb, h, ac)
    _close(dx, rce._resize_transposed(dwb, 1, rows, h), STAGE_TOL)
    want = rce.resize_ce_map_reference_backward(logits, labels, logz, ct, ac)
    _close(dx.to(torch.bfloat16).float(), want.float(), D_TOL)


def _variants(probe: Path = PROBE) -> dict:
    """VARIANTS of a probe script, read as text (the script imports the
    card's tooling)."""
    for node in ast.parse(probe.read_text()).body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "VARIANTS"):
            return ast.literal_eval(node.value)
    raise AssertionError("the probe defines no VARIANTS")


def _kernel_lines(src: str, name: str):
    """The 0-based lines [first, last] of the __global__ function `name`,
    from its signature to its closing brace; None where it is not
    defined."""
    m = re.search(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                  + re.escape(name) + r"\s*\(", src)
    if m is None:
        return None
    depth, end = 0, None
    for j in range(src.index("{", m.end()), len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            end = j
            break
    return src.count("\n", 0, m.start()), src.count("\n", 0, end)


def check_variant(cu: Path, probe: Path, variant: str):
    """The probe's variant names one kernel that `cu` defines and changes
    lines inside that kernel's body only, each of its texts found once in
    the file (a probe that patched another kernel would time the wrong
    one)."""
    src = cu.read_text()
    designs = _variants(probe)[variant]
    defined = {k: _kernel_lines(src, k) for k in designs}
    defined = {k: v for k, v in defined.items() if v is not None}
    assert len(defined) == 1, f"{variant}: kernels defined {defined}"
    (kernel, (first, last)), = defined.items()
    out = src
    for old, new in designs[kernel]:
        assert src.count(old) == 1, f"{variant}: {old!r} not once in the file"
        out = out.replace(old, new)
    changed = [i for tag, i1, i2, _, _ in difflib.SequenceMatcher(
        None, src.splitlines(), out.splitlines()).get_opcodes()
        if tag != "equal" for i in range(i1, max(i2, i1 + 1))]
    assert changed, f"{variant} changes nothing"
    assert all(first < i <= last for i in changed), (
        f"{variant}: lines {changed} outside {kernel} ({first}-{last})")


@pytest.mark.parametrize("variant", ["k1b_no_wpass", "k3b_no_wpass",
                                     "k3b_fast_exp", "k3b_one_kstep",
                                     "k3b_no_dw_store", "k1f_no_exp",
                                     "k1f_no_hpass", "k1f_no_store"])
def test_probe_variant_patches_only_its_kernel(variant):
    check_variant(CU, PROBE, variant)
