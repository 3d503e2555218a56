"""Times K1 (`ops.resize_ce.resize_ce_forward` and `resize_ce_backward`) at
FastSCNN's training shape (`chip_smoke.K1_PATH`, (8,128,256,19) ->
(8,1024,2048)) and K3 (`resize_ce_map_forward`, `resize_ce_map_backward`)
at DeepLab's OHEM shape (`chip_smoke.K3_PATH`), with the library call
beside each, as `chip_smoke.check_resize_ce` and `check_resize_ce_map` time
it:

    python3 scripts/torch_resize_ce_probe.py [--root DIR]
        [--variants k1b_no_wpass]

`--root` names the checkout whose port package is timed (default: this
one), so that two commits can be compared on one card in one command
(e.g. a `git archive` of the parent under the ignored `_chipcheck/`, run
as parent, change, change, parent). Variant, built from a patched copy of
the checkout's `csrc/resize_ce.cu` and timed through the same wrapper:
- `k1b_no_wpass`: K1's backward without its transposed W pass and the
  accumulation of the transposed H pass (d(logits) is then wrong); what
  is left is the H pass, the exponentials and the walk over the rows.

Prints the card, what ptxas reported for each kernel instance of
`resize_ce.cu` (registers, spills, shared memory), the backward's launch
geometry from the plan, then one line per kernel: ms a launch on CUDA
events (the median of 3 runs of 20 launches), the same from a CUDA graph
of 20 launches (without the wrapper's host time), the library call's ms
and the error against the plain version; a digest of K3's outputs (equal
digests: equal bits); then one JSON line. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from pathlib import Path

from torch_fwd_probe import ptxas_lines
from torch_mbconv_bwd_probe import graph_ms

HERE = Path(__file__).resolve().parent.parent

# variant: the (text, its replacement) pairs tried in turn on the source;
# the first whose text is found is applied (one pair for each kernel design)
VARIANTS = {
    "k1b_no_wpass": (
        # the gather design: skip the W-pass loop and the s_acc update
        ("    if (!top && !bot) continue;\n", "    continue;\n"),
        # the banded-product design: skip the products and the H sum
        ("    if (has_unit) {  // the banded product, then the transposed H "
         "pass\n", "    if (false) {\n"),
    ),
}


def build_variant(kernels, variant: str):
    import ctypes
    import subprocess
    src = (kernels.CSRC / "resize_ce.cu").read_text()
    for old, new in VARIANTS[variant]:
        if old in src:
            src = src.replace(old, new)
            break
    else:
        raise SystemExit(f"{variant}: resize_ce.cu has none of its texts")
    cu = kernels.BUILD_DIR / "probe" / f"resize_ce-{variant}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {variant}:\n{proc.stderr}")
    return ctypes.CDLL(str(so))


def digest(*tensors) -> str:
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--variants", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, root)

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke
    from torch_semantic_segmentation_tpu_torch import kernels
    from torch_semantic_segmentation_tpu_torch.ops import resize_ce as rce

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"root {root}; device: {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {chip_smoke.smi_line()}", flush=True)
    print("ptxas resize_ce:\n  " + "\n  ".join(ptxas_lines(kernels,
                                                            "resize_ce")),
          flush=True)
    rows, sums = [], {}

    n, h, w, c, oh, ow = chip_smoke.K1_PATH
    plan = rce._plan(h, w, oh, ow, c, False)
    print("K1 plan: " + ", ".join(
        f"{k}={v}" for k, v in plan._asdict().items()
        if k not in ("itab", "ftab")), flush=True)
    logits, labels, cw = chip_smoke.resize_ce_inputs(n, h, w, c, oh, ow, 7,
                                                     True)
    loss, s2, logz = rce.resize_ce_forward(logits, labels, cw)
    scale = (0.7 / s2).reshape(1)

    def k1_bwd():
        return rce.resize_ce_backward(logits, labels, cw, logz, scale)

    def k1_err():
        dx, ref = k1_bwd(), rce.resize_ce_reference_backward(
            logits, labels, cw, logz, scale)
        return (float((dx.float() - ref.float()).abs().max()),
                float(ref.float().abs().max()))

    lab = labels.long()
    lg = logits.detach().permute(0, 3, 1, 2).requires_grad_(True)

    def k1_library():
        up = F.interpolate(lg, size=(oh, ow), mode="bilinear",
                           align_corners=False)
        return F.cross_entropy(up.float(), lab, weight=cw, ignore_index=255)

    with torch.no_grad():
        lib_fwd = chip_smoke.library_ms(k1_library, iters=5)
    out = k1_library()
    lib_bwd = chip_smoke.library_ms(
        lambda: torch.autograd.grad(out, lg, retain_graph=True), iters=5)
    del out
    err, errscale = k1_err()
    fwd = lambda: rce.resize_ce_forward(logits, labels, cw)  # noqa: E731
    for name, fn, lib_ms, e in (("K1 fwd", fwd, lib_fwd, None),
                                ("K1 bwd", k1_bwd, lib_bwd, err)):
        r = dict(kernel=name, shape=[n, h, w, c, oh, ow],
                 ms=chip_smoke.cuda_ms(fn, reps=3), graph_ms=graph_ms(fn),
                 library_ms=lib_ms, err=e,
                 scale=None if e is None else errscale)
        rows.append(r)
        print(f"{name} ({n},{h},{w},{c})->({oh},{ow}): ms {r['ms']:.4f} "
              f"(graph {r['graph_ms']}) library {lib_ms:.4f}"
              + ("" if e is None
                 else f"; d(logits) err {e:.3g} of {errscale:.3g}"),
              flush=True)

    real_load = kernels.load
    for v in filter(None, args.variants.split(",")):
        lib = build_variant(kernels, v)
        kernels.load = lambda name, _lib=lib: (
            _lib if name == "resize_ce" else real_load(name))
        r = dict(kernel="K1 bwd", variant=v,
                 ms=chip_smoke.cuda_ms(k1_bwd, reps=3),
                 graph_ms=graph_ms(k1_bwd))
        rows.append(r)
        print(f"K1 bwd {v}: ms {r['ms']:.4f} (graph {r['graph_ms']})",
              flush=True)
        kernels.load = real_load
    del logits, labels, cw, logz, lg, lab

    n, h, w, c, oh, ow = chip_smoke.K3_PATH
    logits, labels, _ = chip_smoke.resize_ce_inputs(n, h, w, c, oh, ow, 11,
                                                    False)
    labels = labels.to(torch.int32)
    ct = torch.randn((n, oh, ow), generator=torch.Generator(
        device="cuda").manual_seed(11), device="cuda") * 1e-5
    lmap, logz = rce.resize_ce_map_forward(logits, labels)
    dx = rce.resize_ce_map_backward(logits, labels, logz, ct)
    dref = rce.resize_ce_map_reference_backward(logits, labels, logz, ct)
    k3_err = float((dx.float() - dref.float()).abs().max())
    k3_digest = digest(lmap, logz, dx)
    lab = labels.long()
    lg = logits.detach().permute(0, 3, 1, 2).requires_grad_(True)

    def k3_library():
        up = F.interpolate(lg, size=(oh, ow), mode="bilinear",
                           align_corners=False)
        return F.cross_entropy(up.float(), lab, ignore_index=255,
                               reduction="none")

    with torch.no_grad():
        lib_fwd = chip_smoke.library_ms(k3_library, iters=5)
    out = k3_library()
    lib_bwd = chip_smoke.library_ms(
        lambda: torch.autograd.grad(out, lg, ct, retain_graph=True), iters=5)
    del out
    fwd = lambda: rce.resize_ce_map_forward(logits, labels)  # noqa: E731
    bwd = lambda: rce.resize_ce_map_backward(  # noqa: E731
        logits, labels, logz, ct)
    for name, fn, lib_ms in (("K3 fwd", fwd, lib_fwd),
                             ("K3 bwd", bwd, lib_bwd)):
        r = dict(kernel=name, shape=[n, h, w, c, oh, ow],
                 ms=chip_smoke.cuda_ms(fn, reps=3), graph_ms=graph_ms(fn),
                 library_ms=lib_ms)
        rows.append(r)
        print(f"{name} ({n},{h},{w},{c})->({oh},{ow}): ms {r['ms']:.4f} "
              f"(graph {r['graph_ms']}) library {lib_ms:.4f}", flush=True)
    print(f"K3 d(logits) err {k3_err:.3g}; outputs digest {k3_digest}",
          flush=True)
    for r in rows:
        if "variant" not in r:
            sums[r["kernel"]] = r["ms"]
    print(json.dumps({"root": root, "ms": sums, "k3_digest": k3_digest,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
