"""Times K1 (`ops.resize_ce.resize_ce_forward` and `resize_ce_backward`) at
FastSCNN's training shape (`chip_smoke.K1_PATH`, (8,128,256,19) ->
(8,1024,2048)) and K3 (`resize_ce_map_forward`, `resize_ce_map_backward`)
at DeepLab's OHEM shape (`chip_smoke.K3_PATH`), or with `--k3 x8` / `--k3
x4` at BASELINE config 5's main heads (BiSeNet's `K3_PATH_X8`, ICNet's
`K3_PATH_X4`), with the library call beside each, as
`chip_smoke.check_resize_ce` and `check_resize_ce_map` time it:

    python3 scripts/torch_resize_ce_probe.py [--root DIR] [--k3 x16|x8|x4]
        [--variants k1b_no_wpass,k1f_no_exp,...]

`--root` names the checkout whose port package is timed (default: this
one), so that two commits can be compared on one card in one command
(e.g. a `git archive` of the parent under the ignored `_chipcheck/`, run
as parent, change, change, parent). A variant is built from a patched copy
of the checkout's `csrc/resize_ce.cu` and timed through the same wrapper.
Each names the kernel it patches, one name for each design that kernel
has had; the design the source defines is patched, every one of its
(text, replacement) pairs inside that kernel's body, and the probe stops
when the body lacks one (never patching another kernel):
- `k1b_no_wpass`: K1's backward (`resize_ce_bwd_mma`) without its banded
  products and its H sum (d(logits) is then wrong); what is left is the
  staging, the H pass, the exponentials and the walk over the rows.
- `k3b_no_wpass`: K3's backward without its transposed W pass: the
  gather's loop and `s_acc` update (`resize_ce_bwd`, before the two-phase
  design), or phase A's products and dw stores (`resize_ce_map_bwd_w`).
- `k3b_fast_exp`: phase A's exponentials by `__expf` (what exact
  exponentials cost there).
- `k3b_one_kstep`, `k3b_no_dw_store`: phase A's products over one k step
  of each tile, or without their dw stores (what the products' loop and
  their stores cost; d(logits) is then wrong).
- `k1f_no_exp`, `k1f_no_hpass`, `k1f_no_store`: the forward (K1's and
  K3's, one body: `resize_ce_fwd` before the run design,
  `resize_ce_fwd_runs` since) with its exponentials replaced by an add,
  without its H pass (and, since the run design, the staging of its x
  rows; the buffer left as it is), or without its logz and loss-map
  stores; each is timed at K1's and at K3's shape.

Prints the card, what ptxas reported for each kernel instance of
`resize_ce.cu` (registers, spills, shared memory), the forward's SASS
opcode counts at C = 19 (cuobjdump), K1's and K3's plans,
then one line per kernel: ms a launch on CUDA events (the median of 3 runs
of 20 launches), the same from a CUDA graph of 20 launches (without the
wrapper's host time), the library call's ms and the error against the
plain version; digests of each forward's outputs (K1: loss, S2, logz; K3:
loss map, logz) and of each backward's d(logits), the backward fed the
plain version's logz (and S2), so that its digest reads the backward
alone: equal digests, equal bits; what one K3 backward allocates; its time
by kernel from torch.profiler; then one JSON line. Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys
from pathlib import Path

import numpy as np
from torch_fwd_probe import ptxas_lines
from torch_mbconv_bwd_probe import graph_ms

HERE = Path(__file__).resolve().parent.parent

# variant: {kernel: its (text, replacement) pairs}, one kernel name for each
# design the kernel has had
VARIANTS = {
    "k1b_no_wpass": {
        # K1's banded products and the H sum
        "resize_ce_bwd_mma": (
            ("    if (has_unit) {  // the banded product, then the transposed H "
             "pass\n", "    if (false) {\n"),),
    },
    "k3b_no_wpass": {
        # the gather: the W-pass loop and the s_acc update
        "resize_ce_bwd": (("    if (!top && !bot) continue;\n",
                           "    continue;\n"),),
        # phase A: the products and the dw stores
        "resize_ce_map_bwd_w": (
            ("    if (has_unit) {  // the products\n", "    if (false) {\n"),),
    },
    "k3b_fast_exp": {
        # phase A's exponentials by the approximate __expf
        "resize_ce_map_bwd_w": (("expf(y0 - lz)", "__expf(y0 - lz)"),
                                ("expf(y1 - lz)", "__expf(y1 - lz)")),
    },
    "k3b_one_kstep": {
        # phase A's products over one k step of each tile, not all
        "resize_ce_map_bwd_w": (
            ("  const int ks = has_unit ? mt.tile_ks[tile] : 0;\n",
             "  const int ks = has_unit ? min(mt.tile_ks[tile], 1) : 0;\n"),),
    },
    "k3b_no_dw_store": {
        # phase A's products kept, their dw stores skipped (all but NaNs)
        "resize_ce_map_bwd_w": (("        if (j >= w) continue;\n",
                                 "        if (j >= w || c0[0] == c0[0]) continue;\n"),),
    },
    "k1f_no_exp": {
        # the forward's exponentials replaced by an add (K1's and K3's: one
        # body)
        "resize_ce_fwd": (("      s += expf(y);\n", "      s += y;\n"),),
        "resize_ce_fwd_runs": (
            ("      if (4 * q + e < c) s += ex2_approx(LOG2E * logit(av[e], bv[e], "
             "wl, wh));\n",
             "      if (4 * q + e < c) s += logit(av[e], bv[e], wl, wh);\n"),),
    },
    "k1f_no_hpass": {
        # the forward's H pass skipped, its buffer left as it is
        "resize_ce_fwd": (
            ("    h_pass(xn, s_t, w, c, tb.row_lo[o], tb.row_hi[o], "
             "tb.row_wlo[o], tb.row_whi[o], tlo,\n           ntc);\n", ""),),
        # (and its staging)
        "resize_ce_fwd_runs": (
            ("    if (!vec_x || (hl == staged_lo && hh == staged_hi)) return;\n",
             "    return;\n"),
            ("  h_row(o_begin, 0);\n", ""),
            ("      h_row(o + 1, buf ^ 1);  // into the other buffer: no reader "
             "waits on it\n", "")),
    },
    "k1f_no_store": {
        # the forward's logz and loss-map stores skipped (all but NaNs)
        "resize_ce_fwd": (
            ("    logz[px] = __float2bfloat16(lz);\n",
             "    if (lz != lz) logz[px] = __float2bfloat16(lz);\n"),
            ("      loss_map[px] = wv * (lz - tl);\n",
             "      if (tl != tl) loss_map[px] = wv * (lz - tl);\n")),
        "resize_ce_fwd_runs": (
            ("      if (vec_io) {\n",
             "      if (lz[0] == lz[0]) {\n      } else if (vec_io) {\n"),),
    },
}
# the kernels each variant's time is taken of
TIMED = {"k1b_no_wpass": ("K1 bwd",), "k3b_no_wpass": ("K3 bwd",),
         "k3b_fast_exp": ("K3 bwd",), "k3b_one_kstep": ("K3 bwd",),
         "k3b_no_dw_store": ("K3 bwd",), "k1f_no_exp": ("K1 fwd", "K3 fwd"),
         "k1f_no_hpass": ("K1 fwd", "K3 fwd"),
         "k1f_no_store": ("K1 fwd", "K3 fwd")}


def kernel_body(src: str, name: str) -> tuple[int, int] | None:
    """[start, end) of the body of the __global__ function `name` in `src`,
    braces included; None where the source defines no such kernel."""
    m = re.search(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                  + re.escape(name) + r"\s*\(", src)
    if m is None:
        return None
    depth, i = 0, m.end()
    while True:            # the parameter list's closing parenthesis
        depth += {"(": 1, ")": -1}.get(src[i], 0)
        if depth < 0:
            break
        i += 1
    start = src.index("{", i)
    depth = 0
    for j in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return start, j + 1
    raise SystemExit(f"{name}: unbalanced braces")


def patched(src: str, variant: str, variants: dict = VARIANTS,
            source: str = "resize_ce.cu") -> str:
    """`src` (the text of `source`) with the variant's pairs applied inside
    its kernel's body."""
    designs = variants[variant]
    found = {k: kernel_body(src, k) for k in designs}
    found = {k: v for k, v in found.items() if v is not None}
    if len(found) != 1:
        raise SystemExit(f"{variant}: {source} defines {sorted(found)} "
                         f"of its kernels {sorted(designs)}; one expected")
    (kernel, (start, end)), = found.items()
    body = src[start:end]
    for old, new in designs[kernel]:
        if body.count(old) != 1:
            raise SystemExit(f"{variant}: {kernel} holds {body.count(old)} "
                             f"copies of {old!r}, one expected")
        body = body.replace(old, new)
    return src[:start] + body + src[end:]


def build_variant(kernels, variant: str):
    import ctypes
    import subprocess
    src = patched((kernels.CSRC / "resize_ce.cu").read_text(), variant)
    cu = kernels.BUILD_DIR / "probe" / f"resize_ce-{variant}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {variant}:\n{proc.stderr}")
    return ctypes.CDLL(str(so))


def kernel_ms(fn, iters: int = 10) -> dict:
    """ms a call of each resize_ce kernel that `fn` launches, from
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
        m = re.search(r"resize_ce_\w+", e.key)
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if m and us:
            out[m.group(0)] = out.get(m.group(0), 0.0) + us / 1e3 / iters
    return out


def sass_counts(kernels, name: str, instances: tuple[str, ...]) -> dict:
    """The SASS opcodes of each kernel instance whose mangled name holds
    one of `instances`, counted from `cuobjdump -sass` of the built
    `csrc/<name>.cu` ({} where the toolkit has no cuobjdump)."""
    import collections
    import subprocess
    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    out = subprocess.run([str(tool), "-sass", str(kernels.build(name).path)],
                         capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = next((i for i in instances if i in m.group(1)), None)
            if fn:
                counts[fn] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                      line)
        if m and fn:
            counts[fn][m.group(1)] += 1
    return {k: dict(total=sum(v.values()), **dict(v.most_common(12)))
            for k, v in counts.items()}


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
    ap.add_argument("--k3", choices=("x16", "x8", "x4"), default="x16",
                    help="K3's shape: DeepLab's x16, config 5's x8 or x4 "
                         "(x8 and x4 need this checkout's chip_smoke.py)")
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
    from torch_semantic_segmentation_tpu_torch.ops import resize_ce as rce

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"root {root}; device: {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {chip_smoke.smi_line()}", flush=True)
    print("ptxas resize_ce:\n  " + "\n  ".join(ptxas_lines(kernels,
                                                            "resize_ce")),
          flush=True)
    # the forward's C = 19 instances: K1's with uint8 labels, K3's with
    # int32 (the mangled template arguments)
    sass = sass_counts(kernels, "resize_ce", ("fwd_runsIhLb0ELi19E",
                                              "fwd_runsIiLb1ELi19E"))
    for k, v in sass.items():
        print(f"SASS {k}: {v}", flush=True)
    rows, sums, digests, timed = [], {}, {}, {}

    def plan_line(name, n, h, w, c, oh, ow):
        plan = rce._plan(h, w, oh, ow, c, False)
        print(f"{name} plan: " + ", ".join(
            f"{k}={v}" for k, v in plan._asdict().items()
            if not isinstance(v, (np.ndarray, torch.Tensor))), flush=True)

    def library_rows(shape, fns, err, errscale):
        for name, fn, lib_ms in fns:
            e = err if name.endswith("bwd") else None
            r = dict(kernel=name, shape=list(shape),
                     ms=chip_smoke.cuda_ms(fn, reps=3), graph_ms=graph_ms(fn),
                     library_ms=lib_ms, err=e,
                     scale=None if e is None else errscale)
            rows.append(r)
            n, h, w, c, oh, ow = shape
            print(f"{name} ({n},{h},{w},{c})->({oh},{ow}): ms {r['ms']:.4f} "
                  f"(graph {r['graph_ms']}) library {lib_ms:.4f}"
                  + ("" if e is None
                     else f"; d(logits) err {e:.3g} of {errscale:.3g}"),
                  flush=True)

    def library_pair(logits, labels, shape, **ce):
        """The library call's forward and backward ms: F.interpolate then
        F.cross_entropy, and its backward (for the cotangent `ct` of a
        map)."""
        _, _, _, _, oh, ow = shape
        ct = ce.pop("ct", None)
        lab = labels.long()
        lg = logits.detach().permute(0, 3, 1, 2).requires_grad_(True)

        def library():
            up = F.interpolate(lg, size=(oh, ow), mode="bilinear",
                               align_corners=False)
            return F.cross_entropy(up.float(), lab, ignore_index=255, **ce)

        with torch.no_grad():
            lib_fwd = chip_smoke.library_ms(library, iters=5)
        out = library()
        lib_bwd = chip_smoke.library_ms(
            lambda: torch.autograd.grad(out, lg, ct, retain_graph=True),
            iters=5)
        return lib_fwd, lib_bwd

    # K1 at FastSCNN's training shape
    k1_shape = chip_smoke.K1_PATH
    n, h, w, c, oh, ow = k1_shape
    plan_line("K1", *k1_shape)
    logits1, labels1, cw = chip_smoke.resize_ce_inputs(n, h, w, c, oh, ow, 7,
                                                       True)
    loss, s2, logz1 = rce.resize_ce_forward(logits1, labels1, cw)
    scale = (0.7 / s2).reshape(1)

    def k1_fwd():
        return rce.resize_ce_forward(logits1, labels1, cw)

    def k1_bwd():
        return rce.resize_ce_backward(logits1, labels1, cw, logz1, scale)

    dx1 = k1_bwd()
    ref1 = rce.resize_ce_reference_backward(logits1, labels1, cw, logz1, scale)
    err1 = float((dx1.float() - ref1.float()).abs().max())
    scale1 = float(ref1.float().abs().max())
    del ref1, dx1
    # the forward's bits; the backward's from the plain version's logz and
    # S2, so that they read the backward alone
    digests["K1 fwd"] = digest(loss, s2, logz1)
    _, s2p, logzp = rce.resize_ce_reference(logits1, labels1, cw)
    digests["K1 bwd"] = digest(rce.resize_ce_backward(
        logits1, labels1, cw, logzp, (0.7 / s2p).reshape(1)))
    del s2p, logzp
    lib_fwd, lib_bwd = library_pair(logits1, labels1, k1_shape, weight=cw)
    library_rows(k1_shape, (("K1 fwd", k1_fwd, lib_fwd),
                                  ("K1 bwd", k1_bwd, lib_bwd)),
                 err1, scale1)
    timed["K1 fwd"], timed["K1 bwd"] = k1_fwd, k1_bwd

    # K3 at DeepLab's OHEM shape or config 5's, int32 labels as
    # `augment_batch` gives them
    k3_shape = {"x16": "K3_PATH", "x8": "K3_PATH_X8", "x4": "K3_PATH_X4"}
    k3_shape = getattr(chip_smoke, k3_shape[args.k3])
    n, h, w, c, oh, ow = k3_shape
    plan_line("K3", *k3_shape)
    logits3, labels3, _ = chip_smoke.resize_ce_inputs(n, h, w, c, oh, ow, 11,
                                                      False)
    labels3 = labels3.to(torch.int32)
    ct = torch.randn((n, oh, ow), generator=torch.Generator(
        device="cuda").manual_seed(11), device="cuda") * 1e-5
    lmap, logz3 = rce.resize_ce_map_forward(logits3, labels3)

    def k3_fwd():
        return rce.resize_ce_map_forward(logits3, labels3)

    def k3_bwd():
        return rce.resize_ce_map_backward(logits3, labels3, logz3, ct)

    dx3 = k3_bwd()
    ref3 = rce.resize_ce_map_reference_backward(logits3, labels3, logz3, ct)
    err3 = float((dx3.float() - ref3.float()).abs().max())
    scale3 = float(ref3.float().abs().max())
    del ref3, dx3
    digests["K3 fwd"] = digest(lmap, logz3)
    digests["K3 bwd"] = digest(rce.resize_ce_map_backward(
        logits3, labels3, rce.resize_ce_map_reference(logits3, labels3)[1],
        ct))
    lib_fwd, lib_bwd = library_pair(logits3, labels3, k3_shape, ct=ct,
                                    reduction="none")
    library_rows(k3_shape, (("K3 fwd", k3_fwd, lib_fwd),
                                  ("K3 bwd", k3_bwd, lib_bwd)),
                 err3, scale3)
    timed["K3 fwd"], timed["K3 bwd"] = k3_fwd, k3_bwd
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k3_bwd()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    print("digests: " + ", ".join(f"{k} {v}" for k, v in digests.items())
          + f"; one K3 backward allocates at most {peak} bytes above what "
          "was live", flush=True)
    phases = kernel_ms(k3_bwd)
    print("K3 bwd by kernel (torch.profiler, ms a call): " + (", ".join(
        f"{k} {v:.4f}" for k, v in phases.items()) or "not measured"),
        flush=True)

    real_load = kernels.load
    for v in variants:
        lib = build_variant(kernels, v)
        kernels.load = lambda name, _lib=lib: (
            _lib if name == "resize_ce" else real_load(name))
        for kernel in TIMED[v]:
            fn = timed[kernel]
            r = dict(kernel=kernel, variant=v,
                     ms=chip_smoke.cuda_ms(fn, reps=3), graph_ms=graph_ms(fn))
            rows.append(r)
            print(f"{kernel} {v}: ms {r['ms']:.4f} (graph {r['graph_ms']})",
                  flush=True)
        kernels.load = real_load
    for r in rows:
        if "variant" not in r:
            sums[r["kernel"]] = r["ms"]
    print(json.dumps({"root": root, "ms": sums, "digests": digests,
                      "sass": sass,
                      "k3_bwd_peak_bytes": peak, "k3_bwd_kernels": phases,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
