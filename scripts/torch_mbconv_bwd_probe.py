"""Times K2's backward (`ops.mbconv.expand_dw_backward`) at each block shape
of FastSCNN's training step (`chip_smoke.K2_PATH`, b8 at 1024x2048), and
variants of it built from a patched copy of `csrc/mbconv.cu`:

    python3 scripts/torch_mbconv_bwd_probe.py [--root DIR]
        [--variants base,no_wgrad_atomics,one_chunk]

`--root` names the checkout whose port package is timed (default: this
one), so that two commits can be compared on one card in one command.
Variants:
- `base`: the source as it is;
- `no_wgrad_atomics`: every `atomicAdd` of the source compiled out (dW′,
  db′ and dk are then wrong; dx is checked);
- `one_chunk`: the source as it is, at Ce = 64 (one 64-wide chunk) over the
  same pixels.

Prints the card, one line per shape and variant (ms a launch on CUDA
events, the median of 3 runs of 20 launches, as `chip_smoke.py` times it;
the same from a CUDA graph of 20 launches, without the wrapper's host
time; dx's relative L2 error against the plain version), the sums over the
nine blocks, and one JSON line. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

DROP = ("template <typename T, typename U>\n"
        "__device__ __forceinline__ void k2_probe_drop(T*, U) {}\n")


def patched(source: str, variant: str) -> str:
    if variant != "no_wgrad_atomics":
        return source
    if "atomicAdd(" not in source:
        raise SystemExit("no_wgrad_atomics: the source has no atomicAdd")
    head, sep, tail = source.partition("namespace {\n")
    return head + sep + DROP + tail.replace("atomicAdd(", "k2_probe_drop(")


def build_variant(kernels, variant: str) -> tuple[str, ctypes.CDLL, str]:
    src = patched((kernels.CSRC / "mbconv.cu").read_text(), variant)
    key = hashlib.sha256((src + " ".join(kernels.NVCC_FLAGS)).encode())
    out_dir = kernels.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"mbconv-{key.hexdigest()[:16]}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {variant}:\n{proc.stderr}")
    log = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
           if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return variant, ctypes.CDLL(str(so)), "\n".join(log)


def graph_ms(fn, iters: int = 20) -> float | None:
    """ms a call of `fn` replayed from a CUDA graph of `iters` calls: the
    card's time without the wrapper's host time (None if the capture
    fails)."""
    import torch
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (3 * iters)
    except RuntimeError as e:
        print(f"graph capture failed: {e}", flush=True)
        return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--variants", default="base,no_wgrad_atomics,one_chunk")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke
    from torch_semantic_segmentation_tpu_torch import kernels
    from torch_semantic_segmentation_tpu_torch.ops import mbconv

    print(f"root {root}; device: {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {chip_smoke.smi_line()}", flush=True)
    variants = args.variants.split(",")
    sources = sorted({"base" if v == "one_chunk" else v for v in variants})
    with ThreadPoolExecutor(len(sources)) as pool:
        built = {v: (lib, log) for v, lib, log in
                 pool.map(lambda v: build_variant(kernels, v), sources)}
    for v, (_, log) in built.items():
        print(f"build {v}:\n  " + log.replace("\n", "\n  "), flush=True)

    real_load = kernels.load
    sums = {v: 0.0 for v in variants}
    gsums = {v: 0.0 for v in variants}
    rows = []
    for i, (n, h, w, cin, ce, s, count) in enumerate(chip_smoke.K2_PATH):
        for v in variants:
            lib = built["base" if v == "one_chunk" else v][0]
            kernels.load = lambda name, _lib=lib: _lib
            c = 64 if v == "one_chunk" else ce
            x, wt, b, k = chip_smoke.mbconv_inputs(n, h, w, cin, c, 400 + i)
            ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
            g = torch.randn((n, ho, wo, c), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(i)).to(torch.bfloat16)
            got = mbconv.expand_dw_backward(x, wt, b, k, g, s)
            ref = mbconv.expand_dw_reference_backward(x, wt, b, k, g, s)
            dx_rel = float((got[0].float() - ref[0].float()).norm()
                           / ref[0].float().norm())
            ms = chip_smoke.cuda_ms(
                lambda: mbconv.expand_dw_backward(x, wt, b, k, g, s),
                iters=20, warmup=3, reps=3)
            gms = graph_ms(
                lambda: mbconv.expand_dw_backward(x, wt, b, k, g, s))
            sums[v] += count * ms
            gsums[v] += count * (gms or float("nan"))
            rows.append(dict(shape=[n, h, w, cin, c, s], blocks=count,
                             variant=v, ms=ms, graph_ms=gms,
                             dx_rel_l2=dx_rel))
            print(f"({n},{h},{w},{cin})x{c} s{s} x{count} {v}: bwd_ms "
                  f"{ms:.4f} (graph {gms}); dx rel L2 {dx_rel:.3g}",
                  flush=True)
            del x, wt, b, k, g, got, ref
    kernels.load = real_load
    for v, t in sums.items():
        print(f"nine blocks a step, {v}: {t:.4f} ms (graph {gsums[v]:.4f})",
              flush=True)
    print(json.dumps({"root": root, "sums_ms": sums, "graph_sums_ms": gsums,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
