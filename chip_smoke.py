"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
1. the device, and its name and power limit from nvidia-smi;
2. build the Hopper kernels from `torch_semantic_segmentation_tpu_torch/csrc`,
   one nvcc for each source, all started together;
3. hold each kernel, forward and backward where it has one, against its
   plain PyTorch version at the shapes the serving and training paths give
   it (and at a few ragged shapes), and time the kernel, the plain version,
   one library call and the card's bound;
4. serve FastSCNN at full width (19 classes, bf16 compute, float32
   parameters from a seed, batch 8 of 1024x2048 uint8 frames): 5 requests,
   with the kernel launch counts read around them; then hold the folded,
   fused float32 predictor against the unfolded eval model on the card;
5. train FastSCNN at full width (bf16 compute, float32 parameters, SGD
   with momentum and poly LR, the x8 resize inside the loss) on batches of
   8 uint8 frames of 1024x2048 with learnable labels: one warm-up step and 8
   timed steps, with the kernel launch counts read around them; 4 steps
   with K2 unrouted as a yardstick; then hold the routed bf16 gradient
   against the float32 one, which routes no kernel, and against the plain
   versions' (`grad_check`);
6. print the kernels line, the nvidia-smi line and the final JSON line.

It imports nothing of JAX, and exits non-zero without a CUDA card or
without the port package beside it.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# The card's published peaks (H100 SXM data sheet, dense): the bound of a
# kernel is the larger of bytes / HBM rate and operations / peak rate.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12
# exponentials on the special-function units: 16 a clock on each of the 132
# SMs at the 1.98 GHz boost clock (H100 SXM)
EXP_PER_S = 132 * 16 * 1.98e9

SERVE_BATCH, SERVE_H, SERVE_W, NUM_CLASSES = 8, 1024, 2048, 19
REQUESTS = 5
K5_PER_REQUEST = 3

# (name, dilation, relu_mid, relu_out): the three K5 launches of one request
K5_PATH_CASES = (("ffm", 4, True, False), ("classifier.ds1", 1, True, True),
                 ("classifier.ds2", 1, True, True))
K5_PATH_SHAPE = (SERVE_BATCH, SERVE_H // 8, SERVE_W // 8, 128, 128)
# ragged shapes (n, h, w, c, co, d): tile edges, C off and on the 32-channel
# chunk, Co off the 16-wide product tiles and above one 128-wide pass
K5_RAGGED = ((2, 37, 45, 24, 40, 2), (1, 5, 70, 3, 5, 1), (2, 9, 33, 160, 72, 4),
             (2, 9, 33, 64, 136, 4))
BF16_TOL = 2.0 ** -6   # of max|plain|: two bf16 steps at the top of the range

TRAIN_STEPS = 8
UNROUTED_STEPS = 4
K2_PER_STEP = 9
# K1 on the training path: logits (8,128,256,19) -> labels (8,1024,2048)
K1_PATH = (SERVE_BATCH, SERVE_H // 8, SERVE_W // 8, NUM_CLASSES, SERVE_H,
           SERVE_W)
# ragged (n, h, w, c, oh, ow): OW not a multiple of 128, C of 19, 3 and 66
K1_RAGGED = ((2, 8, 12, 19, 64, 96), (1, 5, 7, 3, 40, 56),
             (2, 6, 20, 66, 48, 160))
# K2 on the training path, the nine GFE blocks at b8:
# (n, h, w, cin, ce, stride, blocks of this shape)
K2_PATH = ((8, 128, 256, 64, 384, 2, 1), (8, 64, 128, 64, 384, 1, 2),
           (8, 64, 128, 64, 384, 2, 1), (8, 32, 64, 96, 576, 1, 3),
           (8, 32, 64, 128, 768, 1, 2))
# ragged (n, h, w, cin, ce, stride): odd W at stride 1, Ce off the 64-wide
# chunk, odd H and W at stride 2
K2_RAGGED = ((2, 9, 19, 16, 96, 1), (1, 8, 12, 24, 72, 2),
             (2, 7, 13, 12, 40, 2))


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 1) -> float:
    """ms a call on CUDA events: the median over `reps` repeats of the mean
    over `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def library_ms(fn, iters: int = 20) -> float:
    """A library yardstick's ms a call: cuDNN chooses its algorithms by
    timing them (benchmark mode) rather than by its heuristics, and the
    median of 5 repeats is kept."""
    import torch
    with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                    deterministic=False, allow_tf32=False):
        return cuda_ms(fn, iters=iters, warmup=5, reps=5)


def sepconv_inputs(n, h, w, c, co, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    return (r(n, h, w, c).to(dtype), r(3, 3, c, scale=0.3), r(c, scale=0.1),
            r(c, co, scale=c ** -0.5).to(dtype), r(co, scale=0.1))


def sepconv_bound(n, h, w, c, co, esize) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): x read and out written once, the
    weights once; the 1x1 product at the tensor-core rate of its type, the
    taps at the float32 rate."""
    px = n * h * w
    moved = px * (c + co) * esize + 9 * c * 4 + c * 4 + c * co * esize + co * 4
    pw_rate = BF16_TENSOR_FLOPS if esize == 2 else FP32_FLOPS
    ops_s = 2 * px * c * co / pw_rate + 2 * 9 * px * c / FP32_FLOPS
    bytes_s = moved / HBM_BYTES_PER_S
    return 1e3 * max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s else "operations"


def check_sepconv() -> dict:
    import torch
    import torch.nn.functional as F
    from torch_semantic_segmentation_tpu_torch.ops.sepconv import (
        fused_separable_conv, separable_conv_reference)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def compare(args, d, rm, ro, dtype):
        got = fused_separable_conv(*args, dilation=d, relu_mid=rm, relu_out=ro)
        want = separable_conv_reference(*args, dilation=d, relu_mid=rm,
                                        relu_out=ro)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"sepconv {tuple(got.shape)}/{got.dtype} vs "
                 f"{tuple(want.shape)}/{want.dtype}")
        err = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            ok = bool((err <= 1e-4 + 1e-4 * want.abs()).all())
        else:
            ok = float(err.max()) <= BF16_TOL * float(want.float().abs().max())
        return float(err.max()), float(want.float().abs().max()), ok

    for i, (n, h, w, c, co, d) in enumerate(K5_RAGGED):
        for dtype in (torch.float32, torch.bfloat16):
            args = sepconv_inputs(n, h, w, c, co, dtype, 100 + i)
            err, scale, ok = compare(args, d, True, i % 2 == 0, dtype)
            print(f"sepconv ragged n{n} h{h} w{w} c{c} co{co} d{d} {dtype}: "
                  f"max_abs_err {err:.3g} (scale {scale:.3g})", flush=True)
            if not ok:
                fail(f"sepconv ragged case {i} {dtype} disagrees with its "
                     "plain version")

    n, h, w, c, co = K5_PATH_SHAPE
    rows = []
    for i, (name, d, rm, ro) in enumerate(K5_PATH_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            args = sepconv_inputs(n, h, w, c, co, dtype, i)
            err, scale, ok = compare(args, d, rm, ro, dtype)
            tol = "rtol=atol=1e-4" if dtype == torch.float32 else \
                f"{BF16_TOL:g}*scale"
            print(f"sepconv {name} {tuple(args[0].shape)} d{d} {dtype}: "
                  f"max_abs_err {err:.3g} (scale {scale:.3g}, tol {tol})",
                  flush=True)
            if not ok:
                fail(f"sepconv {name} {dtype} disagrees with its plain version")
        # times at the path's dtype, bf16
        x, dwk, dwb, pwk, pwb = args
        kernel_ms = cuda_ms(lambda: fused_separable_conv(
            x, dwk, dwb, pwk, pwb, dilation=d, relu_mid=rm, relu_out=ro))
        plain_ms = cuda_ms(lambda: separable_conv_reference(
            x, dwk, dwb, pwk, pwb, dilation=d, relu_mid=rm, relu_out=ro))
        # yardstick only: cuDNN's dw conv then 1x1 conv in bf16, channels_last
        xc = x.permute(0, 3, 1, 2)
        dw_w = dwk.permute(2, 0, 1).unsqueeze(1).to(x.dtype)
        pw_w = pwk.t().reshape(co, c, 1, 1).contiguous(
            memory_format=torch.channels_last)
        dwb_t, pwb_t = dwb.to(x.dtype), pwb.to(x.dtype)

        def library():
            y = F.conv2d(xc, dw_w, dwb_t, padding=d, dilation=d, groups=c)
            y = F.relu(y) if rm else y
            y = F.conv2d(y, pw_w, pwb_t)
            return F.relu(y) if ro else y

        lib_ms = library_ms(library)
        bound_ms, bound_by = sepconv_bound(n, h, w, c, co, 2)
        print(f"sepconv {name} bf16: kernel_ms {kernel_ms:.4f} plain_ms "
              f"{plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms "
              f"{bound_ms:.4f}", flush=True)
        rows.append(dict(err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms))
    k = len(rows)
    out = {key: (max(r[key] for r in rows) if key == "err"
                 else sum(r[key] for r in rows) / k) for key in rows[0]}
    out["bound_by"] = bound_by
    return out


def bound(moved_bytes: float, ops_s: dict) -> tuple[float, str, str]:
    """(least ms, "bytes" or "operations", the term that binds): the larger
    of the bytes over the HBM rate and each kind of operation over its
    unit's rate (the units run side by side)."""
    terms = {"bytes": moved_bytes / HBM_BYTES_PER_S, **ops_s}
    which = max(terms, key=terms.get)
    return (1e3 * terms[which], "bytes" if which == "bytes" else "operations",
            which)


def resize_ce_inputs(n, h, w, c, oh, ow, seed, weights):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = (torch.randn(n, h, w, c, generator=g, device="cuda") * 2).to(
        torch.bfloat16)
    labels = torch.randint(0, c, (n, oh, ow), generator=g, device="cuda"
                           ).to(torch.uint8)
    labels[:, :max(1, oh // 16)] = 255          # a band of ignored rows
    cw = (torch.rand(c, generator=g, device="cuda") * 1.5 + 0.5 if weights
          else torch.ones(c, device="cuda"))
    return logits, labels, cw


def check_resize_ce() -> dict:
    """K1 forward and backward against the plain version; times at the
    training path's shape."""
    import torch
    import torch.nn.functional as F
    from torch_semantic_segmentation_tpu_torch.ops import resize_ce as rce

    def compare(n, h, w, c, oh, ow, weights, seed, name):
        logits, labels, cw = resize_ce_inputs(n, h, w, c, oh, ow, seed,
                                              weights)
        loss, s2, logz = rce.resize_ce_forward(logits, labels, cw)
        want = rce.resize_ce_reference(logits, labels, cw)
        scale = (0.7 / s2).reshape(1)
        dx = rce.resize_ce_backward(logits, labels, cw, logz, scale)
        dref = rce.resize_ce_reference_backward(logits, labels, cw, logz,
                                                scale)
        torch.cuda.synchronize()
        lerr = abs(float(loss) - float(want[0]))
        zerr = float((logz.float() - want[2].float()).abs().max())
        zscale = float(want[2].float().abs().max())
        derr = float((dx.float() - dref.float()).abs().max())
        dscale = float(dref.float().abs().max())
        print(f"resize_ce {name} ({n},{h},{w},{c})->({oh},{ow}) weights "
              f"{weights}: loss {float(loss):.6f} err {lerr:.3g} (tol 1e-4 "
              f"rel); logz err {zerr:.3g} (scale {zscale:.3g}); d(logits) "
              f"err {derr:.3g} (scale {dscale:.3g}, tol {BF16_TOL:g}*scale)",
              flush=True)
        if (lerr > 1e-4 * abs(float(want[0])) + 1e-6
                or abs(float(s2) - float(want[1])) > 1e-6 * float(want[1])
                or zerr > BF16_TOL * zscale or derr > BF16_TOL * dscale
                or dx.dtype != torch.bfloat16):
            fail(f"resize_ce {name} disagrees with its plain version")
        return lerr, derr, (logits, labels, cw, logz, scale)

    for i, (n, h, w, c, oh, ow) in enumerate(K1_RAGGED):
        compare(n, h, w, c, oh, ow, i % 2 == 1, 200 + i, "ragged")
    n, h, w, c, oh, ow = K1_PATH
    errs = []
    for weights in (False, True):
        lerr, derr, args = compare(n, h, w, c, oh, ow, weights, 7, "path")
        errs.append((lerr, derr))
    logits, labels, cw, logz, scale = args
    fwd_ms = cuda_ms(lambda: rce.resize_ce_forward(logits, labels, cw))
    bwd_ms = cuda_ms(lambda: rce.resize_ce_backward(logits, labels, cw, logz,
                                                    scale))
    plain_fwd = cuda_ms(lambda: rce.resize_ce_reference(logits, labels, cw),
                        iters=3, warmup=1)
    plain_bwd = cuda_ms(lambda: rce.resize_ce_reference_backward(
        logits, labels, cw, logz, scale), iters=3, warmup=1)
    # yardstick only: F.interpolate then F.cross_entropy, and its backward
    lab = labels.long()
    lg = logits.detach().permute(0, 3, 1, 2).requires_grad_(True)

    def library():
        up = F.interpolate(lg, size=(oh, ow), mode="bilinear",
                           align_corners=False)
        return F.cross_entropy(up.float(), lab, weight=cw, ignore_index=255)

    with torch.no_grad():
        lib_fwd = library_ms(library, iters=5)
    out = library()
    lib_bwd = library_ms(lambda: torch.autograd.grad(out, lg,
                                                     retain_graph=True),
                         iters=5)
    px, lab_bytes = n * oh * ow, labels.element_size()
    exps = px * c / EXP_PER_S
    fb = bound(n * h * w * c * 2 + px * lab_bytes + px * 2 + 4 * c,
               {"exp": exps, "flop": (px * c * 4 + n * oh * w * c * 3)
                / FP32_FLOPS})
    bb = bound(2 * n * h * w * c * 2 + px * lab_bytes + px * 2 + 4 * c,
               {"exp": exps, "flop": (px * c * 10 + n * oh * w * c * 5)
                / FP32_FLOPS})
    for d, k_ms, p_ms, l_ms, b in (("fwd", fwd_ms, plain_fwd, lib_fwd, fb),
                                   ("bwd", bwd_ms, plain_bwd, lib_bwd, bb)):
        print(f"resize_ce {d} path: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
              f"library_ms {l_ms:.4f} bound_ms {b[0]:.4f} (bound by {b[2]})",
              flush=True)
    return {
        "fwd": dict(err=max(e[0] for e in errs), kernel_ms=fwd_ms,
                    plain_ms=plain_fwd, library_ms=lib_fwd, bound_ms=fb[0],
                    bound_by=fb[1]),
        "bwd": dict(err=max(e[1] for e in errs), kernel_ms=bwd_ms,
                    plain_ms=plain_bwd, library_ms=lib_bwd, bound_ms=bb[0],
                    bound_by=bb[1])}


def mbconv_inputs(n, h, w, cin, ce, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    return (r(n, h, w, cin).to(torch.bfloat16), r(cin, ce, scale=cin ** -0.5),
            r(ce, scale=0.5), r(3, 3, ce, scale=0.5))


def check_mbconv() -> dict:
    """K2 forward and backward against the plain version at each block
    shape of the training path (and ragged ones); per-step times: each
    shape's time times the blocks of that shape, summed over the nine."""
    import torch
    import torch.nn.functional as F
    from torch_semantic_segmentation_tpu_torch.ops import mbconv

    def compare(n, h, w, cin, ce, s, seed, name):
        x, wt, b, k = mbconv_inputs(n, h, w, cin, ce, seed)
        y = mbconv.expand_dw_forward(x, wt, b, k, s)
        want = mbconv.expand_dw_reference(x, wt, b, k, s)
        g = (torch.randn(y.shape, generator=torch.Generator(
            device="cuda").manual_seed(seed), device="cuda")).to(torch.bfloat16)
        got = mbconv.expand_dw_backward(x, wt, b, k, g, s)
        ref = mbconv.expand_dw_reference_backward(x, wt, b, k, g, s)
        torch.cuda.synchronize()
        fe = float((y.float() - want.float()).abs().max())
        fs = float(want.float().abs().max())
        msg = [f"y {fe:.3g}/{fs:.3g}"]
        ok = y.shape == want.shape and fe <= BF16_TOL * fs
        # The backward's ReLU mask is e > 0 on e recomputed by each side:
        # where x.W' + b' rounds to within a float32 step of 0 the two sums
        # may disagree on the sign, and that element of dem differs by all
        # of de. So the backward is held on the relative L2 error and on
        # the share of elements beyond the bf16 bar.
        be = 0.0
        for nm, a, r_ in zip(("dx", "dW", "db", "dk"), got, ref):
            d = (a.float() - r_.float()).abs()
            sc = float(r_.float().abs().max())
            rel = float(d.norm() / r_.float().norm().clamp_min(1e-30))
            beyond = float((d > BF16_TOL * sc).float().mean())
            msg.append(f"{nm} {float(d.max()):.3g}/{sc:.3g} l2 {rel:.2g} "
                       f"beyond {beyond:.2g}")
            ok = ok and a.shape == r_.shape and rel <= 2.0 ** -7 \
                and beyond <= 1e-3
            be = max(be, float(d.max()))
        print(f"mbconv {name} ({n},{h},{w},{cin})x{ce} s{s}: max err/scale "
              f"{' '.join(msg)} (y within {BF16_TOL:g}*scale; backward: l2 "
              f"<= 2^-7 and at most 1e-3 of elements beyond "
              f"{BF16_TOL:g}*scale)", flush=True)
        if not ok or got[0].dtype != torch.bfloat16:
            fail(f"mbconv {name} disagrees with its plain version")
        return fe, be, (x, wt, b, k, g)

    for i, (n, h, w, cin, ce, s) in enumerate(K2_RAGGED):
        compare(n, h, w, cin, ce, s, 300 + i, "ragged")
    tot = {key: 0.0 for key in ("fwd_ms", "bwd_ms", "plain_fwd", "plain_bwd",
                                "lib_fwd", "lib_bwd", "lib_bwd_heuristic")}
    fbytes = bbytes = 0.0
    fops = {"tensor": 0.0, "fp32": 0.0}
    bops = {"tensor": 0.0, "fp32": 0.0}
    ferr = berr = 0.0
    for i, (n, h, w, cin, ce, s, count) in enumerate(K2_PATH):
        fe, be, (x, wt, b, k, g) = compare(n, h, w, cin, ce, s, 400 + i,
                                           "path")
        ferr, berr = max(ferr, fe), max(berr, be)
        t = dict(
            fwd_ms=cuda_ms(lambda: mbconv.expand_dw_forward(x, wt, b, k, s)),
            bwd_ms=cuda_ms(lambda: mbconv.expand_dw_backward(x, wt, b, k, g,
                                                             s)),
            plain_fwd=cuda_ms(lambda: mbconv.expand_dw_reference(
                x, wt, b, k, s), iters=3, warmup=1),
            plain_bwd=cuda_ms(lambda: mbconv.expand_dw_reference_backward(
                x, wt, b, k, g, s), iters=3, warmup=1))
        # yardstick only: cuDNN's 1x1 conv -> ReLU -> depthwise conv in
        # bf16, channels_last, and its autograd backward
        xc = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
        w1 = wt.t().reshape(ce, cin, 1, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last).requires_grad_(True)
        b1 = b.to(torch.bfloat16).requires_grad_(True)
        kd = k.permute(2, 0, 1).unsqueeze(1).to(torch.bfloat16).requires_grad_(
            True)

        def library():
            e = F.relu(F.conv2d(xc, w1, b1))
            return F.conv2d(e, kd, None, stride=s, padding=1, groups=ce)

        with torch.no_grad():
            t["lib_fwd"] = library_ms(library)
        out, gl = library(), g.permute(0, 3, 1, 2)
        t["lib_bwd"] = library_ms(lambda: torch.autograd.grad(
            out, (xc, w1, b1, kd), gl, retain_graph=True))
        # the same backward on cuDNN's heuristics, as earlier runs timed it
        t["lib_bwd_heuristic"] = cuda_ms(lambda: torch.autograd.grad(
            out, (xc, w1, b1, kd), gl, retain_graph=True), reps=5)
        print(f"mbconv path ({n},{h},{w},{cin})x{ce} s{s}: " + " ".join(
            f"{key} {v:.4f}" for key, v in t.items()), flush=True)
        for key in tot:
            tot[key] += count * t[key]
        pin = n * h * w
        pout = n * ((h - 1) // s + 1) * ((w - 1) // s + 1)
        wbytes = cin * ce * 2 + 10 * ce * 4
        fbytes += count * (pin * cin * 2 + pout * ce * 2 + wbytes)
        bbytes += count * (2 * pin * cin * 2 + pout * ce * 2 + wbytes
                           + (cin + 10) * ce * 4)
        fops["tensor"] += count * 2 * pin * cin * ce / BF16_TENSOR_FLOPS
        fops["fp32"] += count * 2 * 9 * pout * ce / FP32_FLOPS
        bops["tensor"] += count * 3 * 2 * pin * cin * ce / BF16_TENSOR_FLOPS
        bops["fp32"] += count * 2 * 2 * 9 * pout * ce / FP32_FLOPS
    fb, bb = bound(fbytes, fops), bound(bbytes, bops)
    for d, k_ms, p_ms, l_ms, bd in (
            ("fwd", tot["fwd_ms"], tot["plain_fwd"], tot["lib_fwd"], fb),
            ("bwd", tot["bwd_ms"], tot["plain_bwd"], tot["lib_bwd"], bb)):
        print(f"mbconv {d} nine blocks a step: kernel_ms {k_ms:.4f} plain_ms "
              f"{p_ms:.4f} library_ms {l_ms:.4f} bound_ms {bd[0]:.4f} (bound "
              f"by {bd[2]})", flush=True)
    print(f"mbconv bwd nine blocks a step: library_ms on cuDNN's heuristics "
          f"{tot['lib_bwd_heuristic']:.4f}", flush=True)
    return {
        "fwd": dict(err=ferr, kernel_ms=tot["fwd_ms"], plain_ms=tot["plain_fwd"],
                    library_ms=tot["lib_fwd"], bound_ms=fb[0], bound_by=fb[1]),
        "bwd": dict(err=berr, kernel_ms=tot["bwd_ms"], plain_ms=tot["plain_bwd"],
                    library_ms=tot["lib_bwd"], bound_ms=bb[0], bound_by=bb[1])}


def calibrated_state(frames) -> dict:
    """FastSCNN's state from a seed, with BN running stats set by one
    forward pass over two of the frames (as a trained model's statistics
    match its data) and BN affine params drawn from a seed: activations
    keep their scale through the random layers, so the ids vary over the
    image, and folding is not the identity."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        normalize_batch)
    from torch_semantic_segmentation_tpu_torch.models import get_model

    model = get_model("fastscnn", NUM_CLASSES, upsample_logits=False,
                      seed=0, device="cuda").eval()
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None          # cumulative average: one batch sets it
        m.train()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        model(normalize_batch(frames[:2]))
        for m in bns:
            c = m.num_features
            m.weight.copy_(torch.rand(c, generator=g) + 0.5)
            m.bias.copy_(torch.randn(c, generator=g) * 0.2)
    return {k: v.clone() for k, v in model.state_dict().items()}


def build_model(compute_dtype, state: dict):
    import torch
    from torch_semantic_segmentation_tpu_torch.models import get_model
    model = get_model("fastscnn", NUM_CLASSES, upsample_logits=False,
                      compute_dtype=compute_dtype, device="cpu")
    model.load_state_dict(state)
    return model.to(torch.device("cuda"))


def make_batch(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """uint8 frames with structure at the scale the model sees (32x32
    blocks of random colour) plus pixel noise: uniform noise alone averages
    out in the 1/8 and 1/32 branches and gives near-constant ids. The
    labels are a function of each block's colour (16 classes, from the red
    and green quarters), with a band of 255 (ignored) over the top rows."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (SERVE_BATCH, SERVE_H // 32, SERVE_W // 32, 3),
                        dtype=np.int16)
    frames = np.repeat(np.repeat(base, 32, axis=1), 32, axis=2)
    frames += rng.integers(-24, 25, frames.shape, dtype=np.int16)
    classes = (base[..., 0] // 64) * 4 + base[..., 1] // 64
    labels = np.repeat(np.repeat(classes, 32, axis=1), 32, axis=2)
    labels[:, :SERVE_H // 16] = 255
    return np.clip(frames, 0, 255).astype(np.uint8), labels.astype(np.uint8)


def make_frames(seed: int) -> np.ndarray:
    return make_batch(seed)[0]


def serve() -> dict:
    import torch
    from torch_semantic_segmentation_tpu_torch.ops.sepconv import (
        fused_separable_conv)
    from torch_semantic_segmentation_tpu_torch.serving import make_predict_fn

    frames = torch.from_numpy(make_frames(0)).cuda()
    state = calibrated_state(frames)

    predict = make_predict_fn(build_model(torch.bfloat16, state), output="ids")
    ids = predict(frames)                    # warm-up
    torch.cuda.synchronize()

    fused_separable_conv.launches = 0
    lat = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        ids = predict(frames)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    launches = fused_separable_conv.launches

    if tuple(ids.shape) != (SERVE_BATCH, SERVE_H, SERVE_W) or ids.dtype != torch.uint8:
        fail(f"ids {tuple(ids.shape)} {ids.dtype}")
    if int(ids.max()) >= NUM_CLASSES:
        fail(f"class id {int(ids.max())} out of range")
    if launches != K5_PER_REQUEST * REQUESTS:
        fail(f"sepconv launched {launches} times in {REQUESTS} requests, "
             f"expected {K5_PER_REQUEST * REQUESTS}")
    counts = torch.bincount(ids.flatten().long(), minlength=NUM_CLASSES)
    print(f"serve ids: {int((counts > 0).sum())} classes present, the most "
          f"common on {float(counts.max()) / ids.numel():.3f} of pixels",
          flush=True)
    lat_ms = [1e3 * t for t in lat]
    print(f"serve bf16 {SERVE_BATCH}x{SERVE_H}x{SERVE_W}: latency_ms "
          f"{[round(t, 3) for t in lat_ms]} median {np.median(lat_ms):.3f}; "
          f"frames/s {SERVE_BATCH * REQUESTS / sum(lat):.2f}; "
          f"sepconv launches {launches}", flush=True)

    # float32: folded + fused predictor vs the unfolded eval model
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    folded, unfolded = build_model(None, state), build_model(None, state)
    fused_logits = make_predict_fn(folded, output="logits")(frames)
    fused_ids = make_predict_fn(folded, output="ids")(frames)
    plain_logits = make_predict_fn(unfolded, fold_bn=False,
                                   output="logits")(frames)
    plain_ids = make_predict_fn(unfolded, fold_bn=False, output="ids")(frames)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(fused_logits).all()):
        fail("non-finite logits")
    err = float((fused_logits - plain_logits).abs().max())
    scale = float(plain_logits.abs().max())
    mismatch = float((fused_ids != plain_ids).float().mean())
    bf16_vs_f32 = float((ids != plain_ids).float().mean())
    present = int((torch.bincount(plain_ids.flatten().long()) > 0).sum())
    print(f"serve f32 folded+fused vs unfolded: logits max_abs_err {err:.3g} "
          f"(scale {scale:.3g}, tol 1e-4*scale + 1e-5); id mismatch "
          f"{mismatch:.3g} (tol 1e-3) over {present} classes present; bf16 "
          f"ids vs f32 unfolded: mismatch {bf16_vs_f32:.3g}", flush=True)
    if present < 2:
        fail("the f32 ids hold one class: the id comparison would be empty")
    if err > 1e-4 * scale + 1e-5:
        fail("folded+fused f32 logits disagree with the unfolded model")
    if mismatch >= 1e-3:
        fail("folded+fused f32 ids disagree with the unfolded model")
    return dict(launches=launches, latency_ms=lat_ms)


# the kernel wrappers of the training path: (count key, module, wrapper,
# plain version)
TRAIN_WRAPPERS = (
    ("resize_ce_fwd", "resize_ce", "resize_ce_forward", "resize_ce_reference"),
    ("resize_ce_bwd", "resize_ce", "resize_ce_backward",
     "resize_ce_reference_backward"),
    ("mbconv_fwd", "mbconv", "expand_dw_forward", "expand_dw_reference"),
    ("mbconv_bwd", "mbconv", "expand_dw_backward",
     "expand_dw_reference_backward"))


def train_wrappers() -> list:
    """[(count key, module, wrapper name, plain version)]."""
    import importlib
    out = []
    for key, mod_name, name, plain in TRAIN_WRAPPERS:
        mod = importlib.import_module(
            f"torch_semantic_segmentation_tpu_torch.ops.{mod_name}")
        out.append((key, mod, name, getattr(mod, plain)))
    return out


def launch_counts() -> dict:
    return {key: getattr(mod, name).launches
            for key, mod, name, _ in train_wrappers()}


def reset_launch_counts():
    for _, mod, name, _ in train_wrappers():
        getattr(mod, name).launches = 0


@contextlib.contextmanager
def swapped(replace):
    """Within the block the autograd functions of K1 and K2 call
    `replace(key, wrapper, plain)` in place of each kernel wrapper: a
    yardstick of this script only (the port's wrappers launch the kernels
    for every CUDA tensor). A wrapper counts its launches on the name it
    is called by, so the replacement carries the count and hands it back."""
    saved = [(mod, name, getattr(mod, name), key, plain)
             for key, mod, name, plain in train_wrappers()]
    swaps = []
    try:
        for mod, name, fn, key, plain in saved:
            call = replace(key, fn, plain)
            call.launches = fn.launches
            setattr(mod, name, call)
            swaps.append(call)
        yield
    finally:
        for (mod, name, fn, _, _), call in zip(saved, swaps):
            fn.launches = call.launches
        for mod, name, fn, _, _ in saved:
            setattr(mod, name, fn)


def plain_versions(key, fn, plain):
    """Each wrapper's plain version, on the card too."""
    return lambda *args: plain(*args)


def nudged_plain_versions(key, fn, plain):
    """The plain versions with K2's folded bias b′ moved up by one float32
    step: e = bf16(relu(x·W′ + b′)) then rounds differently wherever the
    float32 sum lies within a step of a bf16 rounding boundary, as a
    different summation order would make it."""
    import torch
    if not key.startswith("mbconv"):
        return lambda *args: plain(*args)

    def call(x, w, b, *rest):
        return plain(x, w, torch.nextafter(b, torch.full_like(b, np.inf)),
                     *rest)
    return call


def recording(calls: list):
    """Each wrapper as it is, with its inputs appended to `calls`."""
    def replace(key, fn, plain):
        def call(*args):
            calls.append((key, fn, plain, args))
            return fn(*args)
        return call
    return replace


@contextlib.contextmanager
def k2_unrouted():
    """Within the block no inverted residual routes to K2: its expand and
    depthwise run as the plain conv layers (a yardstick of this script
    only)."""
    from torch_semantic_segmentation_tpu_torch.ops.blocks import (
        InvertedResidual)
    saved = InvertedResidual._maybe_fused_expand_dw
    InvertedResidual._maybe_fused_expand_dw = lambda self, x: None
    try:
        yield
    finally:
        InvertedResidual._maybe_fused_expand_dw = saved


def rel_l2(a, b) -> float:
    d = (a.double() - b.double()).norm()
    n = b.double().norm()
    return float(d / n) if float(n) > 0 else float(d)


def cosine(a, b) -> float:
    import torch
    a, b = a.double().flatten(), b.double().flatten()
    if float(a.norm()) == 0 and float(b.norm()) == 0:
        return 1.0
    return float(torch.nn.functional.cosine_similarity(a, b, dim=0,
                                                       eps=1e-300))


def check_recorded(calls: list) -> dict:
    """Each kernel launch of a step again, the kernel against its plain
    version on the very inputs the step gave it: every output within a
    relative L2 error of 2^-9 (a cosine of at least 0.999998). Returns the
    worst relative error of each wrapper."""
    import torch
    worst = {}
    for key, fn, plain, args in calls:
        with torch.no_grad():
            got, want = fn(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, r in zip(got, want):
            e = rel_l2(a, r)
            worst[key] = max(worst.get(key, 0.0), e)
            if a.shape != r.shape or a.dtype != r.dtype or not e <= 2.0 ** -9:
                fail(f"{key} on the training step's own inputs: relative L2 "
                     f"error {e:.3g} ({tuple(a.shape)} {a.dtype} vs "
                     f"{tuple(r.shape)} {r.dtype})")
    return worst


def train() -> dict:
    """FastSCNN's training step at full width on the card, through the
    port's entry points (`get_model`, `create_train_state`,
    `make_train_step`, `resize_cross_entropy_loss`)."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        normalize_batch)
    from torch_semantic_segmentation_tpu_torch.losses import (
        resize_cross_entropy_loss)
    from torch_semantic_segmentation_tpu_torch.models import get_model
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)

    batches = []
    for seed in range(1 + TRAIN_STEPS):
        f, lab = make_batch(100 + seed)
        batches.append((normalize_batch(torch.from_numpy(f).cuda()),
                        torch.from_numpy(lab).cuda()))
    model = get_model("fastscnn", NUM_CLASSES, upsample_logits=False,
                      compute_dtype=torch.bfloat16, seed=0, device="cuda")
    state = create_train_state(model, OptimizerConfig(lr=0.045,
                                                      max_steps=1000))
    step = make_train_step(model, state, resize_cross_entropy_loss)
    step(*batches[0])                          # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lat, losses = [], []
    for images, labels in batches[1:]:
        t0 = time.perf_counter()
        m = step(images, labels)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    lat_ms = [1e3 * t for t in lat]
    print(f"train bf16 {SERVE_BATCH}x{SERVE_H}x{SERVE_W}: losses "
          f"{[round(v, 4) for v in losses]}; step latency_ms "
          f"{[round(t, 3) for t in lat_ms]} median {np.median(lat_ms):.3f}; "
          f"images/s {SERVE_BATCH * TRAIN_STEPS / sum(lat):.2f}; "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB; launches "
          f"{launches}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        fail(f"the training loss did not fall: {losses}")
    want = {"resize_ce_fwd": TRAIN_STEPS, "resize_ce_bwd": TRAIN_STEPS,
            "mbconv_fwd": K2_PER_STEP * TRAIN_STEPS,
            "mbconv_bwd": K2_PER_STEP * TRAIN_STEPS}
    if launches != want:
        fail(f"kernel launches in {TRAIN_STEPS} steps: {launches}, expected "
             f"{want}")

    # K2 off the path (a yardstick): the same steps with the nine blocks on
    # the plain conv layers, which store the 6x-wide expanded tensor
    with k2_unrouted():
        step(*batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        lat_u = []
        for images, labels in batches[1:1 + UNROUTED_STEPS]:
            t0 = time.perf_counter()
            step(images, labels)
            torch.cuda.synchronize()
            lat_u.append(time.perf_counter() - t0)
        peak_u = torch.cuda.max_memory_allocated()
    used_u = {k: v - before[k] for k, v in launch_counts().items()}
    lat_u_ms = [1e3 * t for t in lat_u]
    print(f"train bf16 without K2 (blocks on the plain conv layers): step "
          f"latency_ms {[round(t, 3) for t in lat_u_ms]} median "
          f"{np.median(lat_u_ms):.3f} (with K2 {np.median(lat_ms):.3f}); "
          f"max_memory_allocated {peak_u / 2 ** 30:.3f} GiB (with K2 "
          f"{peak / 2 ** 30:.3f}); launches {used_u}", flush=True)
    if used_u["mbconv_fwd"] or used_u["mbconv_bwd"]:
        fail("K2 launched with the blocks unrouted")

    grad = grad_check(model, *batches[-1])
    return dict(launches=launches, latency_ms=lat_ms, losses=losses,
                peak_bytes=peak, unrouted_latency_ms=lat_u_ms,
                unrouted_peak_bytes=peak_u, **grad)


def grad_check(model, images, labels) -> dict:
    """The routed bf16 gradient of one step against the float32 step's
    (which routes neither kernel), and against the same bf16 step through
    the kernels' plain versions, from the same weights, batch and dropout
    masks.

    Asserted:
    - the loss within 2e-2 relative of float32's; d(logits) (K1's
      backward) and the head's gradient at cosine 0.99 against float32's;
    - every K1 and K2 launch of the routed step, run again on its own
      inputs, against its plain version (`check_recorded`);
    - every parameter's gradient at cosine 0.99 against the plain
      versions', except a parameter whose plain-version gradient itself
      falls below 0.999 when K2's folded bias is nudged by one float32
      step (`nudged_plain_versions`): there the train-mode BNs amplify
      which way a bf16 rounding falls, so the kernels' summation order,
      not their function, sets the reading. Those parameters are listed
      with both readings.
    Printed, not asserted: the whole gradient's cosine against float32.
    The JAX package's own bf16 step reads as low against its float32 step
    (tests/test_torch_bf16_grad.py), so the bar of 0.99 on it cannot hold
    for bf16 training with or without the kernels."""
    import torch
    from torch_semantic_segmentation_tpu_torch.losses import (
        resize_cross_entropy_loss)
    from torch_semantic_segmentation_tpu_torch.models import get_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = get_model("fastscnn", NUM_CLASSES, upsample_logits=False,
                    compute_dtype=None, seed=0, device="cuda")
    f32.load_state_dict(model.state_dict())

    def gradient(m):
        m.train()
        m.zero_grad(set_to_none=True)
        m.dropout_generator.manual_seed(1234)
        before = launch_counts()
        logits = m(images)
        logits.retain_grad()
        loss = resize_cross_entropy_loss(logits, labels)
        loss.backward()
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in launch_counts().items()}
        grads = {k: p.grad.float().flatten() for k, p in m.named_parameters()}
        return float(loss.detach()), logits.grad.float().flatten(), grads, used

    def flat(g, keys=None):
        return torch.cat([v for k, v in g.items() if keys is None or k in keys])

    calls = []
    with swapped(recording(calls)):
        l16, d16, g16, used16 = gradient(model)
    worst = check_recorded(calls)
    del calls
    with swapped(plain_versions):
        _, _, gp, _ = gradient(model)
    with swapped(nudged_plain_versions):
        _, _, gn, _ = gradient(model)
    l32, d32, g32, used32 = gradient(f32)
    if any(used32.values()) or used16 != {"resize_ce_fwd": 1,
                                          "resize_ce_bwd": 1,
                                          "mbconv_fwd": K2_PER_STEP,
                                          "mbconv_bwd": K2_PER_STEP}:
        fail("the bf16 step must route every kernel and the f32 step none")
    print("train grad check, each launch of the routed step against its "
          "plain version on the same inputs: worst relative L2 error "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + " (tol 2^-9)", flush=True)

    head = ("classifier.conv.weight", "classifier.conv.bias")
    checks = {"d(logits) vs f32": cosine(d16, d32),
              "head vs f32": cosine(flat(g16, head), flat(g32, head))}
    rel = abs(l16 - l32) / abs(l32)
    whole = {"routed vs f32": cosine(flat(g16), flat(g32)),
             "plain versions vs f32": cosine(flat(gp), flat(g32)),
             "routed vs plain versions": cosine(flat(g16), flat(gp)),
             "nudged vs plain versions": cosine(flat(gn), flat(gp))}
    print(f"train grad check: loss bf16 {l16:.6f} f32 {l32:.6f} (rel "
          f"{rel:.3g}, tol 2e-2); cosine " + ", ".join(
              f"{k} {v:.6f}" for k, v in checks.items()) + " (tol 0.99); "
          "whole gradient, not asserted: " + ", ".join(
              f"{k} {v:.4f}" for k, v in whole.items()), flush=True)
    if not min(checks.values()) >= 0.99 or not rel <= 2e-2:
        fail("the bf16 and float32 losses or heads disagree")

    below, wrong = [], []
    for k in g16:
        c_r, c_n = cosine(g16[k], gp[k]), cosine(gn[k], gp[k])
        if c_r < 0.99:
            below.append(k)
            if c_n >= 0.999:
                wrong.append(k)
            print(f"  leaf {k}: routed vs plain {c_r:.4f}, nudged vs plain "
                  f"{c_n:.4f}, routed vs f32 {cosine(g16[k], g32[k]):.4f}, "
                  f"plain vs f32 {cosine(gp[k], g32[k]):.4f}", flush=True)
    print(f"train grad check, per parameter: {len(g16) - len(below)} of "
          f"{len(g16)} at cosine >= 0.99 against the plain versions; "
          f"{len(below) - len(wrong)} below, each below 0.999 under the "
          f"one-step nudge; {len(wrong)} below without it", flush=True)
    if wrong:
        fail(f"routed gradients off the plain versions' at {wrong}")
    return dict(grad_cosines=dict(checks, **whole),
                recorded_rel_l2=worst, leaves_below=below)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from torch_semantic_segmentation_tpu_torch import kernels
    except ImportError as e:
        fail(f"the port package is not beside this script ({e})")

    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"device: {name} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)

    # one nvcc for each source, all started together
    t0 = time.perf_counter()
    names = ("sepconv", "resize_ce", "mbconv")
    with ThreadPoolExecutor(len(names)) as pool:
        builds = dict(zip(names, pool.map(kernels.build, names)))
    print(f"build: {time.perf_counter() - t0:.1f} s for all", flush=True)
    for kname, built in builds.items():
        print(f"build {kname}: nvcc {built.seconds:.1f} s", flush=True)
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip(), flush=True)

    k5 = check_sepconv()
    k1 = check_resize_ce()
    k2 = check_mbconv()
    served = serve()
    trained = train()

    def row(kname, source, replaces, launches, r):
        return {"name": kname, "route": "cuda",
                "source": f"torch_semantic_segmentation_tpu_torch/csrc/{source}",
                "replaces": f"torch_semantic_segmentation_tpu/ops/{replaces}",
                "launches": launches, "max_abs_err": r["err"],
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]}

    tl = trained["launches"]
    print(json.dumps({"kernels": [
        row("sepconv", "sepconv.cu", "pallas_sepconv.py:239",
            served["launches"], k5),
        row("resize_ce_fwd", "resize_ce.cu", "pallas_resize_ce.py:329",
            tl["resize_ce_fwd"], k1["fwd"]),
        row("resize_ce_bwd", "resize_ce.cu", "pallas_resize_ce.py:381",
            tl["resize_ce_bwd"], k1["bwd"]),
        row("mbconv_fwd", "mbconv.cu", "pallas_mbconv.py:337",
            tl["mbconv_fwd"], k2["fwd"]),
        row("mbconv_bwd", "mbconv.cu", "pallas_mbconv.py:394",
            tl["mbconv_bwd"], k2["bwd"]),
    ]}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
