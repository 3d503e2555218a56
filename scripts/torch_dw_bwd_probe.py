"""Times K6's backward (`ops.depthwise.depthwise3x3_backward`, dx and dk)
at the LDS's two stride-2 convs, GFE stage1[0]'s and the stride-1 shape
(`chip_smoke.K6_PATH`, `K6_OFF_STEP`), bf16 as on the training path, with
the forward beside it:

    python3 scripts/torch_dw_bwd_probe.py [--root DIR]
        [--variants k6b_no_dk,k6b_no_dx,k6b1_no_dk,k6b1_no_dx]

`--root` names the checkout whose port package is timed (default: this
one), so that two commits can be compared on one card in one command
(e.g. a `git archive` of the parent under the ignored `_chipcheck/`, run
as parent, change, change, parent). A variant is built from a patched copy
of this checkout's `csrc/depthwise.cu` and timed through the same wrapper;
it names the kernel it patches and patches only inside that kernel's body
(`torch_resize_ce_probe.patched`), and the probe stops where the body lacks
its text:
- `k6b_no_dk`: the stride-2 backward (`dw_bwd_s2_kernel`) without its dk
  products (dk is then 0); what is left stages x and dy and writes dx;
- `k6b_no_dx`: the same kernel without its dx products and stores (dx is
  then not written);
- `k6b1_no_dk`, `k6b1_no_dx`: the same two cuts of the stride-1 backward
  (`dw_bwd_s1_kernel`).

Prints the card, what ptxas reported for each kernel instance of
`depthwise.cu` (registers, spills, shared memory), the backward's plan
where the library has one (tile, threads, buffers, blocks), then one line
per shape: the backward's ms a launch on CUDA events (the median of 3 runs
of 20 launches, as `chip_smoke.py` times it), the same from a CUDA graph of
20 launches (without the wrapper's host time), its time by kernel from
torch.profiler, cuDNN's backward to x and the kernel (as `chip_smoke.py`
times it), whether dx equals the plain version bit for bit, dk's relative
L2 error and whether two launches give the same dk; digests of y, dx and
dk (equal digests, equal bits between two checkouts); what one backward
allocates above what was live; the forward's ms. Then the sums over ds1 +
ds2 and one JSON line. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

from torch_fwd_probe import ptxas_lines
from torch_mbconv_bwd_probe import graph_ms
from torch_resize_ce_probe import digest, patched

HERE = Path(__file__).resolve().parent.parent

# variant: {kernel: its (text, replacement) pairs}
VARIANTS = {
    "k6b_no_dk": {
        "dw_bwd_s2_kernel": (
            ("      for (int t = 0; t < 9; ++t) {  // dk\n",
             "      for (int t = 0; t < 0; ++t) {  // dk\n"),),
    },
    "k6b_no_dx": {
        "dw_bwd_s2_kernel": (
            ("      {  // dx: the quad (2oy, 2ox) .. (2oy + 1, 2ox + 1)\n",
             "      if (false) {\n"),),
    },
    "k6b1_no_dk": {
        "dw_bwd_s1_kernel": (
            ("              dk[3 * a + d][e] = __fmaf_rn(xv[e], dc[j][e], "
             "dk[3 * a + d][e]);\n",
             "              (void)xv[e];\n"),),
    },
    "k6b1_no_dx": {
        "dw_bwd_s1_kernel": (
            ("            madd_v<BV>(acc[j], dv, kq[d]);\n", ""),
            ("        if (ox + j < w) store_v<BV>(p + size_t(j) * c, valid, "
             "vec, acc[j]);\n",
             "        (void)p;\n")),
    },
}


def build_variant(kernels, variant: str) -> ctypes.CDLL:
    src = patched((kernels.CSRC / "depthwise.cu").read_text(), variant,
                  VARIANTS, "depthwise.cu")
    cu = kernels.BUILD_DIR / "probe" / f"depthwise-{variant}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {variant}:\n{proc.stderr}")
    return ctypes.CDLL(str(so))


def kernel_ms(fn, iters: int = 10) -> dict:
    """ms a call of each depthwise kernel that `fn` launches, from
    torch.profiler's device times ({} where the trace has none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"dw_\w+_kernel", e.key)
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if m and us:
            out[m.group(0)] = out.get(m.group(0), 0.0) + us / 1e3 / iters
    return out


def plan_line(lib, n, h, w, c, s) -> str | None:
    """The backward's plan at stride s, where the library has the query
    (before the stride-1 kernel, the stride-2 backward's alone)."""
    out = (ctypes.c_int * 9)()
    if hasattr(lib, "dw3x3_backward_plan"):
        fn = lib.dw3x3_backward_plan
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_longlong
        rows = fn(n, h, w, c, s, 1, 0, ctypes.addressof(out))
    elif s == 2 and hasattr(lib, "dw3x3_backward_s2_plan"):
        fn = lib.dw3x3_backward_s2_plan
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_longlong
        rows = fn(n, h, w, c, 1, 0, ctypes.addressof(out))
    else:
        return None
    names = ("th", "tw", "threads", "buffers", "smem", "per_sm", "xpitch",
             "dpitch", "run")
    return f"blocks {rows}, " + ", ".join(f"{k} {v}" for k, v in
                                          zip(names, out))


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
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke
    from torch_semantic_segmentation_tpu_torch import kernels
    from torch_semantic_segmentation_tpu_torch.ops import depthwise as dwm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"root {root}; device: {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {chip_smoke.smi_line()}", flush=True)
    print("ptxas depthwise:\n  " + "\n  ".join(ptxas_lines(kernels,
                                                            "depthwise")),
          flush=True)
    lib = dwm._library()
    shapes = list(enumerate(chip_smoke.K6_PATH + chip_smoke.K6_OFF_STEP))
    shapes = [(i, *shape) for i, shape in shapes]
    rows, timed = [], {}
    sums = dict(bwd=0.0, bwd_graph=0.0, bwd_lib=0.0, fwd=0.0)
    for i, name, n, h, w, c, s in shapes:
        x, k, dy = chip_smoke.depthwise_inputs(n, h, w, c, s, torch.bfloat16,
                                               600 + i)
        plan = plan_line(lib, n, h, w, c, s)
        if plan:
            print(f"K6 bwd {name} plan: {plan}", flush=True)
        y = dwm.depthwise3x3_forward(x, k, s)
        dx, dk = dwm.depthwise3x3_backward(x, k, dy, s)
        _, dk2 = dwm.depthwise3x3_backward(x, k, dy, s)
        rdx, rdk = dwm.depthwise3x3_reference_backward(x, k, dy, s)
        r = dict(name=name, shape=[n, h, w, c, s],
                 dx_equal=bool(torch.equal(dx, rdx)),
                 dk_rel_l2=chip_smoke.rel_l2(dk, rdk),
                 dk_same=bool(torch.equal(dk, dk2)),
                 digests=dict(y=digest(y), dx=digest(dx), dk=digest(dk)))
        del rdx, rdk, dx, dk, dk2, y
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dwm.depthwise3x3_backward(x, k, dy, s)
        torch.cuda.synchronize()
        r["bwd_peak_bytes"] = torch.cuda.max_memory_allocated() - before

        def bwd(x=x, k=k, dy=dy, s=s):
            return dwm.depthwise3x3_backward(x, k, dy, s)

        xc = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
        kc = k.permute(2, 0, 1).unsqueeze(1).to(x.dtype).requires_grad_(True)
        out = F.conv2d(xc, kc, None, stride=s, padding=1, groups=c)
        gl = dy.permute(0, 3, 1, 2)
        r.update(bwd_ms=chip_smoke.cuda_ms(bwd, reps=3),
                 bwd_graph_ms=graph_ms(bwd), bwd_kernels=kernel_ms(bwd),
                 bwd_lib_ms=chip_smoke.library_ms(lambda: torch.autograd.grad(
                     out, (xc, kc), gl, retain_graph=True)),
                 fwd_ms=chip_smoke.cuda_ms(
                     lambda: dwm.depthwise3x3_forward(x, k, s), reps=3))
        del xc, kc, out, gl
        rows.append(r)
        timed[name] = bwd
        if (name, n, h, w, c, s) in chip_smoke.K6_PATH:
            for key in sums:
                sums[key] += r[f"{key}_ms"] or float("nan")
        print(f"K6 bwd {name} ({n},{h},{w},{c}) s{s}: ms {r['bwd_ms']:.4f} "
              f"(graph {r['bwd_graph_ms']}); by kernel " + (", ".join(
                  f"{kn} {v:.4f}" for kn, v in r["bwd_kernels"].items())
                  or "not measured")
              + f"; cuDNN {r['bwd_lib_ms']:.4f}; dx equal bits "
              f"{r['dx_equal']}, dk rel L2 {r['dk_rel_l2']:.3g}, dk same in "
              f"two launches {r['dk_same']}; digests {r['digests']}; "
              f"allocates {r['bwd_peak_bytes']} bytes; fwd ms "
              f"{r['fwd_ms']:.4f}", flush=True)
    print("sums over ds1 + ds2: " + " ".join(
        f"{key} {v:.4f}" for key, v in sums.items()), flush=True)

    real_load = kernels.load
    for v in variants:
        vlib = build_variant(kernels, v)
        kernels.load = lambda name, _lib=vlib: (
            _lib if name == "depthwise" else real_load(name))
        total = 0.0
        for i, name, n, h, w, c, s in shapes:
            ms = graph_ms(timed[name])
            rows.append(dict(variant=v, name=name, bwd_graph_ms=ms))
            if (name, n, h, w, c, s) in chip_smoke.K6_PATH:
                total += ms or float("nan")
            print(f"K6 bwd {v} {name} s{s}: graph {ms}", flush=True)
        sums[f"{v}_graph"] = total
        print(f"{v}: ds1 + ds2, graph {total:.4f}", flush=True)
        kernels.load = real_load
    print(json.dumps({"root": root, "sums_ms": sums, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
