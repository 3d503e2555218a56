"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
1. the device, and its name and power limit from nvidia-smi;
2. build the Hopper kernels from `torch_semantic_segmentation_tpu_torch/csrc`;
3. hold each kernel against its plain PyTorch version at the shapes the
   serving path gives it (and at a few ragged shapes), and time the kernel,
   the plain version, one library call and the card's bound;
4. serve FastSCNN at full width (19 classes, bf16 compute, float32
   parameters from a seed, batch 8 of 1024x2048 uint8 frames): 5 requests,
   with the kernel launch counts read around them; then hold the folded,
   fused float32 predictor against the unfolded eval model on the card;
5. print the kernels line, the nvidia-smi line and the final JSON line.

It imports nothing of JAX, and exits non-zero without a CUDA card or
without the port package beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# The card's published peaks (H100 SXM data sheet, dense): the bound of a
# kernel is the larger of bytes / HBM rate and operations / peak rate.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

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


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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

        library_ms = cuda_ms(library)
        bound_ms, bound_by = sepconv_bound(n, h, w, c, co, 2)
        print(f"sepconv {name} bf16: kernel_ms {kernel_ms:.4f} plain_ms "
              f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
              f"{bound_ms:.4f}", flush=True)
        rows.append(dict(err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms))
    k = len(rows)
    out = {key: (max(r[key] for r in rows) if key == "err"
                 else sum(r[key] for r in rows) / k) for key in rows[0]}
    out["bound_by"] = bound_by
    return out


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


def make_frames(seed: int) -> np.ndarray:
    """uint8 frames with structure at the scale the model sees (32x32
    blocks of random colour) plus pixel noise: uniform noise alone averages
    out in the 1/8 and 1/32 branches and gives near-constant ids."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (SERVE_BATCH, SERVE_H // 32, SERVE_W // 32, 3),
                        dtype=np.int16)
    frames = np.repeat(np.repeat(base, 32, axis=1), 32, axis=2)
    frames += rng.integers(-24, 25, frames.shape, dtype=np.int16)
    return np.clip(frames, 0, 255).astype(np.uint8)


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

    t0 = time.perf_counter()
    built = kernels.build("sepconv")
    print(f"build sepconv: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{built.seconds:.1f} s)", flush=True)
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    k5 = check_sepconv()
    served = serve()

    print(json.dumps({"kernels": [{
        "name": "sepconv",
        "route": "cuda",
        "source": "torch_semantic_segmentation_tpu_torch/csrc/sepconv.cu",
        "replaces": "torch_semantic_segmentation_tpu/ops/pallas_sepconv.py:239",
        "launches": served["launches"],
        "max_abs_err": k5["err"],
        "ms": k5["kernel_ms"],
        "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"],
        "library_ms": k5["library_ms"],
    }]}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
