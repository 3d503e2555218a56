"""Times K5 (`ops.sepconv.fused_separable_conv`) at the three launches of
one FastSCNN serving request (`chip_smoke.K5_PATH_CASES` at
`K5_PATH_SHAPE`, (8,128,256,128), C = Co = 128: the FFM's d=4 pair, the
Classifier's ds1 and ds2 at d=1), in bf16 as served and in float32:

    python3 scripts/torch_sepconv_probe.py [--root DIR]
        [--variants k5_no_product,k5_no_taps,k5_no_stage,k5_no_store]

`--root` names the checkout whose port package is timed (default: this
one), so that two commits can be compared on one card in one command
(e.g. a `git archive` of the parent under the ignored `_chipcheck/`, run
as parent, change, change, parent). A variant is built from a patched copy
of the checkout's `csrc/sepconv.cu` and timed through the same wrapper
(bf16). Each names the kernel it patches, one name for each design the
kernel has had; the design the source defines is patched, every one of its
(text, replacement) pairs inside that kernel's body, and the probe stops
when the body lacks one (`torch_resize_ce_probe.patched`):
- `k5_no_product`: the 1x1 product and the store compiled out (out is
  then not written); what is left stages x and runs the taps;
- `k5_no_taps`: the tap pass compiled out (the mid tile is then not
  written); what is left stages x, runs the product and stores;
- `k5_no_stage` (`sepconv_bf16_kernel` only): the staging of x compiled out (the taps
  then read what the buffers hold); what is left is the compute and the
  stores;
- `k5_no_store` (`sepconv_bf16_kernel` only): the stores of out compiled out (out is
  then not written); the product and the epilogue still run.

Prints the card, what ptxas reported for each kernel instance of
`sepconv.cu` (registers, spills, shared memory), then one line per launch
and type: ms a launch on CUDA events (the median of 3 runs of 20 launches,
as `chip_smoke.py` times it), the same from a CUDA graph of 20 launches
(without the wrapper's host time), the error against the plain version
and a digest of the output (equal digests, equal bits between two
checkouts); in bf16 also cuDNN's dw conv then its 1x1 (as `chip_smoke.py`
times it). Then the sums over a request (d=4 + 2 x d=1), each variant's
times and one JSON line. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

from torch_fwd_probe import ptxas_lines
from torch_mbconv_bwd_probe import graph_ms
from torch_resize_ce_probe import digest, patched

HERE = Path(__file__).resolve().parent.parent

# variant: {kernel: its (text, replacement) pairs}, one kernel name for each
# design K5's bf16 path has had (`sepconv_kernel`: wmma, the design before;
# `sepconv_bf16_kernel`: the TMA, ldmatrix and mma.sync)
VARIANTS = {
    "k5_no_product": {
        "sepconv_kernel": (
            ("    product(s_mid, s_pw, s_pwb,",
             "    if (false) product(s_mid, s_pw, s_pwb,"),),
        "sepconv_bf16_kernel": (
            ("    for (int ks = 0; ks < kc * CK / 16; ++ks) {",
             "    for (int ks = 0; ks < 0; ++ks) {"),
            ("        if (gy >= p.h || gx >= p.w) continue;",
             "        if (gy >= 0) continue;"),),
    },
    "k5_no_taps": {
        "sepconv_kernel": (
            ("      if constexpr (VEC) dw_vec(",
             "      if constexpr (VEC) (void)0; else if (false) dw_vec("),),
        "sepconv_bf16_kernel": (
            ("      for (int u = 0; u < M / RUN * PAIRS / THREADS; ++u) {",
             "      for (int u = 0; u < 0; ++u) {"),),
    },
    "k5_no_stage": {
        "sepconv_bf16_kernel": (
            ("  for (int j = 0; j < NBUF - 1; ++j) stage(j);",
             "  for (int j = 0; j < 0; ++j) stage(j);"),
            ("      stage(j + NBUF - 1);",
             "      if (false) stage(j + NBUF - 1);"),
            ("      if constexpr (PATH) mbar_wait(",
             "      if constexpr (false) mbar_wait(")),
    },
    "k5_no_store": {
        "sepconv_bf16_kernel": (
            ("        if (gy >= p.h || gx >= p.w) continue;",
             "        if (gy >= 0) continue;"),),
    },
}


def build_variant(kernels, variant: str) -> ctypes.CDLL:
    src = patched((kernels.CSRC / "sepconv.cu").read_text(), variant,
                  VARIANTS, "sepconv.cu")
    cu = kernels.BUILD_DIR / "probe" / f"sepconv-{variant}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {variant}:\n{proc.stderr}")
    return ctypes.CDLL(str(so))


def library(x, dwk, dwb, pwk, pwb, d, relu_mid, relu_out):
    """cuDNN's dw conv then its 1x1 in x's type, channels_last, as
    `chip_smoke.check_sepconv` times it: a yardstick the port never calls."""
    import torch
    import torch.nn.functional as F
    c, co = pwk.shape
    xc = x.permute(0, 3, 1, 2)
    dw_w = dwk.permute(2, 0, 1).unsqueeze(1).to(x.dtype)
    pw_w = pwk.t().reshape(co, c, 1, 1).contiguous(
        memory_format=torch.channels_last)
    dwb_t, pwb_t = dwb.to(x.dtype), pwb.to(x.dtype)

    def run():
        y = F.conv2d(xc, dw_w, dwb_t, padding=d, dilation=d, groups=c)
        y = F.relu(y) if relu_mid else y
        y = F.conv2d(y, pw_w, pwb_t)
        return F.relu(y) if relu_out else y

    return run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--variants", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    variants = list(filter(None, args.variants.split(",")))
    for v in variants:
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v}; known: {sorted(VARIANTS)}")
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke
    from torch_semantic_segmentation_tpu_torch import kernels
    from torch_semantic_segmentation_tpu_torch.ops import sepconv

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"root {root}; device: {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {chip_smoke.smi_line()}", flush=True)
    print("ptxas sepconv:\n  " + "\n  ".join(ptxas_lines(kernels, "sepconv")),
          flush=True)

    n, h, w, c, co = chip_smoke.K5_PATH_SHAPE
    rows, timed = [], {}
    sums = dict(bf16=0.0, bf16_graph=0.0, bf16_lib=0.0, f32=0.0,
                f32_graph=0.0)
    for i, (name, d, rm, ro) in enumerate(chip_smoke.K5_PATH_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            args5 = chip_smoke.sepconv_inputs(n, h, w, c, co, dtype, i)
            kw = dict(dilation=d, relu_mid=rm, relu_out=ro)
            got = sepconv.fused_separable_conv(*args5, **kw)
            want = sepconv.separable_conv_reference(*args5, **kw)
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())

            def run(args5=args5, kw=kw):
                return sepconv.fused_separable_conv(*args5, **kw)

            tname = "bf16" if dtype == torch.bfloat16 else "f32"
            r = dict(name=name, dilation=d, dtype=tname, err=err, scale=scale,
                     digest=digest(got), ms=chip_smoke.cuda_ms(run, reps=3),
                     graph_ms=graph_ms(run))
            if dtype == torch.bfloat16:
                r["lib_ms"] = chip_smoke.library_ms(library(*args5, d, rm, ro))
                timed[name] = run
            del got, want
            rows.append(r)
            sums[tname] += r["ms"]
            sums[f"{tname}_graph"] += r["graph_ms"] or float("nan")
            if "lib_ms" in r:
                sums["bf16_lib"] += r["lib_ms"]
            print(f"K5 {name} d{d} {tname}: ms {r['ms']:.4f} (graph "
                  f"{r['graph_ms']})"
                  + (f"; cuDNN {r['lib_ms']:.4f}" if "lib_ms" in r else "")
                  + f"; max_abs_err {err:.3g} (scale {scale:.3g}); digest "
                  f"{r['digest']}", flush=True)
    print("sums over a request: " + " ".join(
        f"{key} {v:.4f}" for key, v in sums.items()), flush=True)

    real_load = kernels.load
    for v in variants:
        vlib = build_variant(kernels, v)
        kernels.load = lambda name, _lib=vlib: (
            _lib if name == "sepconv" else real_load(name))
        total = 0.0
        for name, d, _, _ in chip_smoke.K5_PATH_CASES:
            ms = graph_ms(timed[name])
            rows.append(dict(variant=v, name=name, dilation=d, graph_ms=ms))
            total += ms or float("nan")
            print(f"K5 {v} {name} d{d}: graph {ms}", flush=True)
        sums[f"{v}_graph"] = total
        print(f"{v}: a request, graph {total:.4f}", flush=True)
        kernels.load = real_load
    print(json.dumps({"root": root, "sums_ms": sums, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
