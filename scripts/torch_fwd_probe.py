"""Times the forwards of K2 (`ops.mbconv.expand_dw_forward`) at each block
shape of FastSCNN's training step (`chip_smoke.K2_PATH`, b8 at 1024x2048)
and of K6 (`ops.depthwise.depthwise3x3_forward`) at the LDS's two convs,
GFE stage1[0]'s and the stride-1 case (`chip_smoke.K6_PATH`,
`K6_OFF_STEP`), with K2's backward beside them:

    python3 scripts/torch_fwd_probe.py [--root DIR]
        [--variants k6_tall,k2_no_products,k2_no_taps]

`--root` names the checkout whose port package is timed (default: this
one), so that two commits can be compared on one card in one command
(e.g. a `git archive` of the parent under the ignored `_chipcheck/`, run
as parent, change, change, parent). Variants, each built from a patched
copy of this checkout's source and timed through the same wrappers:
- `k6_tall`: K6's forward tiles up to 64 output rows (4 by default);
- `k2_no_products`: K2's expand products compiled out (the fragments still
  load; y is then wrong);
- `k2_no_taps`: K2's tap pass compiled out (y is then not written).

Prints the card, what ptxas reported for each kernel instance of
`mbconv.cu` and `depthwise.cu` (registers, spills, shared memory), then
one line per shape: ms a launch on CUDA events (the median of 3 runs of
20 launches, as `chip_smoke.py` times it), the same from a CUDA graph of
20 launches (without the wrapper's host time), the library call's ms
(cuDNN, as `chip_smoke.py` times it), and the error against the plain
version (K6: whether the bits are equal). Then the sums a step (K2: the
nine blocks; K6: ds1 + ds2) and one JSON line. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

from torch_mbconv_bwd_probe import graph_ms

HERE = Path(__file__).resolve().parent.parent


def ptxas_lines(kernels, name: str) -> list[str]:
    """What ptxas says of each kernel instance of `csrc/<name>.cu`, from a
    build of its own (the library `kernels.build` keeps may predate this
    process, and then it has no log)."""
    out = kernels.BUILD_DIR / "probe" / f"{name}-ptxas.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                           str(kernels.CSRC / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    return [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]


# variant: (source, text, its replacement)
VARIANTS = {
    "k6_tall": ("depthwise", "constexpr int FWD_MAX_ROWS = 4;",
                "constexpr int FWD_MAX_ROWS = 64;"),
    "k2_no_products": ("mbconv", "            mma_bf16(acc[j], a[kt & 1], ",
                       "            if (a[0][0] == 0x12345678u) "
                       "mma_bf16(acc[j], a[kt & 1], "),
    "k2_no_taps": ("mbconv", "    if (cg >= ce) continue;",
                   "    if (cg >= 0) continue;"),
}


def build_variant(kernels, variant: str) -> ctypes.CDLL:
    name, old, new = VARIANTS[variant]
    src = (kernels.CSRC / f"{name}.cu").read_text()
    if old not in src:
        raise SystemExit(f"{variant}: {name}.cu has no {old!r}")
    cu = kernels.BUILD_DIR / "probe" / f"{name}-{variant}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(src.replace(old, new))
    so = cu.with_suffix(".so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {variant}:\n{proc.stderr}")
    return ctypes.CDLL(str(so))


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
    from torch_semantic_segmentation_tpu_torch.ops import depthwise as dwm
    from torch_semantic_segmentation_tpu_torch.ops import mbconv

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"root {root}; device: {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {chip_smoke.smi_line()}", flush=True)
    for name in ("mbconv", "depthwise"):
        print(f"ptxas {name}:\n  " + "\n  ".join(ptxas_lines(kernels, name)),
              flush=True)

    rows = []
    sums = dict(k2_fwd=0.0, k2_fwd_graph=0.0, k2_fwd_lib=0.0, k2_bwd=0.0,
                k2_bwd_graph=0.0, k6_fwd=0.0, k6_fwd_graph=0.0, k6_fwd_lib=0.0)
    for i, (n, h, w, cin, ce, s, count) in enumerate(chip_smoke.K2_PATH):
        x, wt, b, k = chip_smoke.mbconv_inputs(n, h, w, cin, ce, 400 + i)
        y = mbconv.expand_dw_forward(x, wt, b, k, s)
        want = mbconv.expand_dw_reference(x, wt, b, k, s)
        err = float((y.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        g = torch.randn(y.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(i)).to(torch.bfloat16)
        fwd = lambda: mbconv.expand_dw_forward(x, wt, b, k, s)  # noqa: E731
        bwd = lambda: mbconv.expand_dw_backward(  # noqa: E731
            x, wt, b, k, g, s)
        xc = x.permute(0, 3, 1, 2)
        w1 = wt.t().reshape(ce, cin, 1, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        b1 = b.to(torch.bfloat16)
        kd = k.permute(2, 0, 1).unsqueeze(1).to(torch.bfloat16)

        def library():
            e = F.relu(F.conv2d(xc, w1, b1))
            return F.conv2d(e, kd, None, stride=s, padding=1, groups=ce)

        with torch.no_grad():
            r = dict(kernel="K2", shape=[n, h, w, cin, ce, s], count=count,
                     fwd_ms=chip_smoke.cuda_ms(fwd, reps=3),
                     fwd_graph_ms=graph_ms(fwd),
                     fwd_lib_ms=chip_smoke.library_ms(library),
                     bwd_ms=chip_smoke.cuda_ms(bwd, reps=3),
                     bwd_graph_ms=graph_ms(bwd), err=err, scale=scale)
        rows.append(r)
        for key in ("fwd", "fwd_graph", "fwd_lib", "bwd", "bwd_graph"):
            sums[f"k2_{key}"] += count * (r[f"{key}_ms"] or float("nan"))
        print(f"K2 ({n},{h},{w},{cin})x{ce} s{s} x{count}: fwd_ms "
              f"{r['fwd_ms']:.4f} (graph {r['fwd_graph_ms']}) library "
              f"{r['fwd_lib_ms']:.4f}; bwd_ms {r['bwd_ms']:.4f} (graph "
              f"{r['bwd_graph_ms']}); y err {err:.3g} of {scale:.3g}",
              flush=True)
        del x, wt, b, k, y, want, g, xc, w1, b1, kd

    for i, (name, n, h, w, c, s) in enumerate(chip_smoke.K6_PATH
                                              + chip_smoke.K6_OFF_STEP):
        x, k, _ = chip_smoke.depthwise_inputs(n, h, w, c, s, torch.bfloat16,
                                              600 + i)
        same = bool(torch.equal(dwm.depthwise3x3_forward(x, k, s),
                                dwm.depthwise3x3_reference(x, k, s)))
        fwd = lambda: dwm.depthwise3x3_forward(x, k, s)  # noqa: E731
        xc = x.permute(0, 3, 1, 2)
        kc = k.permute(2, 0, 1).unsqueeze(1).to(x.dtype)

        def library():
            return F.conv2d(xc, kc, None, stride=s, padding=1, groups=c)

        with torch.no_grad():
            r = dict(kernel="K6", name=name, shape=[n, h, w, c, s],
                     fwd_ms=chip_smoke.cuda_ms(fwd, reps=3),
                     fwd_graph_ms=graph_ms(fwd),
                     fwd_lib_ms=chip_smoke.library_ms(library),
                     equal_bits=same)
        rows.append(r)
        if (name, n, h, w, c, s) in chip_smoke.K6_PATH:
            for key in ("fwd", "fwd_graph", "fwd_lib"):
                sums[f"k6_{key}"] += r[f"{key}_ms"] or float("nan")
        print(f"K6 {name} ({n},{h},{w},{c}) s{s}: fwd_ms {r['fwd_ms']:.4f} "
              f"(graph {r['fwd_graph_ms']}) library {r['fwd_lib_ms']:.4f}; "
              f"equal bits {same}", flush=True)
        del x, k, xc, kc

    print("sums a step (K2 nine blocks, K6 ds1 + ds2): " + " ".join(
        f"{key} {v:.4f}" for key, v in sums.items()), flush=True)

    real_load = kernels.load
    for v in filter(None, args.variants.split(",")):
        source = VARIANTS[v][0]
        lib = build_variant(kernels, v)
        kernels.load = lambda name, _lib=lib, _src=source: (
            _lib if name == _src else real_load(name))
        total = 0.0
        if source == "mbconv":
            for i, (n, h, w, cin, ce, s, count) in enumerate(
                    chip_smoke.K2_PATH):
                x, wt, b, k = chip_smoke.mbconv_inputs(n, h, w, cin, ce,
                                                       400 + i)
                ms = graph_ms(lambda: mbconv.expand_dw_forward(x, wt, b, k, s))
                total += count * (ms or float("nan"))
                rows.append(dict(kernel="K2", variant=v,
                                 shape=[n, h, w, cin, ce, s], fwd_graph_ms=ms))
                print(f"K2 {v} ({n},{h},{w},{cin})x{ce} s{s}: fwd graph {ms}",
                      flush=True)
        else:
            for i, (name, n, h, w, c, s) in enumerate(chip_smoke.K6_PATH
                                                      + chip_smoke.K6_OFF_STEP):
                x, k, _ = chip_smoke.depthwise_inputs(n, h, w, c, s,
                                                      torch.bfloat16, 600 + i)
                same = bool(torch.equal(dwm.depthwise3x3_forward(x, k, s),
                                        dwm.depthwise3x3_reference(x, k, s)))
                ms = graph_ms(lambda: dwm.depthwise3x3_forward(x, k, s))
                if (name, n, h, w, c, s) in chip_smoke.K6_PATH:
                    total += ms or float("nan")
                rows.append(dict(kernel="K6", variant=v, name=name,
                                 fwd_graph_ms=ms, equal_bits=same))
                print(f"K6 {v} {name}: fwd graph {ms}; equal bits {same}",
                      flush=True)
        sums[f"{v}_graph"] = total
        print(f"{v}: {'nine blocks' if source == 'mbconv' else 'ds1 + ds2'}"
              f" a step, graph {total:.4f}", flush=True)
    kernels.load = real_load
    print(json.dumps({"root": root, "sums_ms": sums, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
