"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
1. the device, and its name and power limit from nvidia-smi;
2. build the Hopper kernels from `torch_semantic_segmentation_tpu_torch/csrc`,
   one nvcc for each source, all started together;
3. hold each kernel, forward and backward where it has one, against its
   plain PyTorch version at the shapes the serving and training paths give
   it (and at a few ragged shapes), and time the kernel, the plain version,
   one library call and the card's bound (K3 at each of its three paths'
   shapes: x16, x8 and x4; K1 at FastSCNN's, LEDNet's and ContextNet's, K2
   and K6 at FastSCNN's and ContextNet's); then K1 and K3 with NaN logits,
   NaN where their plain versions are and the other elements unmoved;
4. serve FastSCNN at full width (19 classes, bf16 compute, float32
   parameters from a seed, batch 8 of 1024x2048 uint8 frames): 5 requests,
   with the kernel launch counts read around them; then hold the folded,
   fused float32 predictor against the unfolded eval model on the card;
5. train FastSCNN at full width (bf16 compute, float32 parameters, SGD
   with momentum and poly LR, the x8 resize inside the loss) on batches of
   8 normalised frames of 1024x2048 with learnable labels: one warm-up step
   and 8 timed steps, with the kernel launch counts read around them; 4
   steps with K2 unrouted and 4 with K6 unrouted as yardsticks; then hold
   the routed bf16 gradient against the float32 one and against the plain
   versions' (`grad_check`);
6. the whole training loop as `bench.py`'s fullres tier runs it: resident
   uint8 frames, a fresh `augment_batch` draw at crop 1024x2048 before each
   step, one warm-up and 8 timed steps, with the launch counts read around
   them (the launches of the kernels line); one step with `remat=True`
   against the same step without it; then the eval step over 4 batches of
   8 frames, and the multi-scale + flip eval step over one batch of 2,
   each with its matrix checked;
7. UNet, bilinear decoder, at full width (base 64, 19 classes, bf16
   compute): serve 5 requests of 8 frames of 1024x2048 and hold the folded
   predictor against the unfolded eval model; train 1 + 8 steps through
   `augment_batch` at crop 768x768, batch 8 (the launches of K4's row);
   one eval batch; one train step of the deconv decoder, which launches
   no kernel;
8. DeepLabV3-ResNet50 (`upsample_logits=False`, bf16): train 1 + 8 steps
   of batch 16 through `augment_batch` at crop 768x768, scale 0.5-2.0,
   with `resize_ohem_cross_entropy` (thresh 0.7, min_kept 100000; the
   launches of K3's rows); one eval batch. In phases 7 and 8 every K4 and
   K3 launch of one train step and one eval batch runs again on its own
   inputs against the plain version, and the step's loss and d(logits)
   are held against the same step through the plain versions;
9. BASELINE config 5, BiSeNet-R18 and then ICNet-R50
   (`upsample_logits=False`, bf16): train 1 + 8 steps of batch 16 through
   `augment_batch` at crop 1024x1024, scale 0.75-2.0, SGD lr 0.025, with
   `aux_weighted_loss` (aux weight 1.0) over OHEM on each head (thresh
   0.7, min_kept 100000): K3 3 + 3 a step, at x8, x8 and x16 (BiSeNet)
   and x4, x8 and x16 (ICNet); the step and every launch held against the
   plain versions as in phase 8; one eval batch of 16 at 1024x2048; for
   BiSeNet one multi-scale + flip batch of 2;
10. BASELINE config 1, ENet (bf16): train 1 + 8 steps of batch 4 through
   `augment_batch` at crop 512x512, scale 0.5-2.0, SGD lr 0.05, with
   class-weighted CE (ENet's weights from the phase's label maps): no
   kernel launches; one eval batch;
11. the stretch zoo, ERFNet, ESNet, LEDNet and ContextNet in turn, at the
   zoo benches' configurations (bf16): serve 5 requests of 8 frames of
   1024x2048 (`upsample_logits=False` and no aux heads where the
   constructor takes them) with the folded-against-unfolded check; train
   1 + 8 steps through `augment_batch` at crop 768x768, SGD lr 0.045,
   batch 8 (ContextNet 32), LEDNet and ContextNet on the fused-resize
   route (K1 1 + 1 a step; ContextNet also K2 12 + 12 and K6 2 + 2, K5 4
   a request); one step and its launches held against the plain versions
   as in phase 8; one eval batch of 8 (ContextNet: 3 K6 launches); for
   ContextNet 4 steps with K2 unrouted as a yardstick;
12. FastSCNN's phase-6 step fed by the port's input path: the loader
   alone (1 + 6 batches of 8 by 4 threads of `batch_iterator` over
   `ShapesDataset` at 1024x2048, with a LUT; the card's machine has no
   libjpeg or libpng headers, so the native loader and the file datasets
   are held on the CPU only), every prefetched device batch against its
   host batch by checksum, then 1 + 8 steps through
   `train_input_pipeline` (pinned prefetch on a side stream,
   `augment_batch` at crop 1024x2048; launches 1 + 1 K1, 9 + 9 K2, 2 + 2
   K6 a step; the loss falls), an asynchronous checkpoint after 4 steps
   while the rest run, held bit for bit against a synchronous copy, and a
   resume into fresh objects whose loader batch and augmentation draw
   equal the uninterrupted run's;
13. the train, eval and predict CLIs, through their `main(argv)` in this
   process: one step of the accuracy run's fused route with every K1 and
   K2 launch held against its plain version (K1 at C = 4, K2 at the GFE's
   16x16, 8x8 and 4x4 maps; both also in phase 3); the accuracy recipe of
   `scripts/make_accuracy_artifact.py` (FastSCNN on `ShapesDataset`,
   batch 8, crop 128, 400 steps, val mIoU every 100) on the default route
   (K2 9 + 9 a step) and with `--fused-resize-loss` (K1 1 + 1 too), each
   best val mIoU above the JAX artifact's mark of 70; the eval CLI on the
   fused run's best checkpoint, single-scale above 70 and multi-scale +
   flip, no launches; `predict_frames` over 13 frames in two resolution
   groups, bit for bit against the serving predictor on the same batches
   (3 K5 launches a batch), its masks through the port's PNG writer read
   back by zlib; then `--config` runs of BASELINE's configs on synthetic
   data, 2 steps each at their own batch and crop (the fullres config at
   b128 of 1024x1024 with remat and the fused loss: K1 1 + 1 and K6 on
   each routed stride-2 depthwise conv, no K2; then one more step of it
   with every K1 and K6 launch held against its plain version on its own
   inputs, the plain version over slices of 16 images), and `unet_camvid`
   refused;
14. data parallelism, on FastSCNN at phase 6's configuration: a NCCL
   group of one in this process, whose two steps equal phase 6's steps
   without a group bit for bit wherever two runs without a group agree
   (else the gap is printed with the tensor it enters at), then 1 + 8
   timed steps with the launches checked (1 + 1 K1, 9 + 9 K2, 2 + 2 K6 a
   step) and the collectives a step counted, and 2 eval batches whose
   matrix equals the one without a group, each beside the step without a
   group timed just before; `profiling.measure` of phase 6's step inside
   the spread of the same step timed as phase 6 times it; then two ranks
   on the one card
   (gloo) through the train CLI's `--multihost` (batch 8 of 1024x2048,
   the fused loss, 3 steps), whose losses equal each other and the
   single-process CLI's within the bars `DP_STEP1_RTOL` and
   `DP_LATER_RTOL`, while this process checks a trace, `cost_analysis`
   and `checked_step` of the step; its launches have a line of their own;
15. spatial sharding, FastSCNN at phase 6's configuration on two gloo
   ranks of one data row (`num_spatial=2`), each on a band of 512 of the
   1024 rows, the halos through host memory: `check_spatial_extent`
   raising at H = 32 over 2 bands; phase 6's first 3 steps in this process
   (timed; steps 1-3 twice again and once with each BN's batch mean one
   float32 step up, the losses' yardstick), then on the ranks: their
   losses within 1e-4 at step 1 and `SP_LATER_RTOL` after, or twice the
   yardstick's spread, step 1's gradient within
   `SP_GRAD_NOISE` times the plain versions' step 1 moved by a one-step
   nudge of K2's folded bias, 1 + 1 K1, 9 + 9 K2 and 2 + 2 K6 a step on each rank,
   every launch of the last step held against its plain version on its
   own inputs, the eval forward's ids and `evaluate`'s matrix against this
   process's; the halo exchanges and bytes, the step times and the peak
   memory printed; its launches have a line of their own;
16. spatial sharding of DeepLabV3-ResNet50 (config 4's OHEM and lr, bf16,
   3 steps), UNet's bilinear decoder (base 64, 1 step), ERFNet and ESNet
   (lr 0.045, 1 step each), each at batch 4 of 768x768 crops (cut from
   16 and 8: every halo goes through host memory under gloo), bands of
   384 rows, ENet at config 1 (batch 4 of 512x512, class-weighted CE,
   2 steps), bands of 256 rows, and BiSeNet-R18 and ICNet-R50 at config 5
   (batch 4 of 1024x1024 cut from 16, aux heads and OHEM, lr 0.025, 1
   step each), bands of 512 rows, on two gloo ranks of one data row: each
   model's steps in this process first (step 1 again, and
   every step with each BN's batch mean one float32 step up: the
   yardsticks), then on the ranks: the losses within phase 15's bars or
   twice the nudge's gaps, step 1's gradient within `SP_GRAD_NOISE` times
   the nudge's, K3 1 + 1 (DeepLab) or 3 + 3 (BiSeNet, ICNet) and K4 4 a
   step on each rank (8 in UNet's eval; ENet, ERFNet and ESNet launch
   none), each model's halo exchanges a
   step (`ZS_HALOS`; phase 15's too, `SP_HALOS`), every launch of the
   last step held against its plain version, each
   band's K4 output bit for bit against the unsharded K4 on the data
   row's gathered input, and the eval forward of the single process's
   trained weights on the bands (ids and matrix); the halo exchanges and
   bytes, step times and peak memory printed on lines of their own;
17. print the kernels line, the nvidia-smi line and the final JSON line.
   K3's rows count the launches of phases 8 and 9, K1's, K2's, K5's and
   K6's those of phases 4-6, 11, 12 and (K1, K2) 13's accuracy runs, and
   each row gives each path's launches and times under "paths".

It imports nothing of JAX, and exits non-zero without a CUDA card or
without the port package beside it.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
import shutil
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
# chunk, Co off the 16-wide product tiles and above one 128-wide pass; then
# C = Co = 128 off the bf16 kernel's 8 x 16 tile at d = 1 and 4 (its
# compile-time instances) and at d = 2 (the runtime one)
K5_RAGGED = ((2, 37, 45, 24, 40, 2), (1, 5, 70, 3, 5, 1), (2, 9, 33, 160, 72, 4),
             (2, 9, 33, 64, 136, 4), (2, 21, 35, 128, 128, 1),
             (2, 19, 45, 128, 128, 4), (1, 13, 27, 128, 128, 2))
BF16_TOL = 2.0 ** -6   # of max|plain|: two bf16 steps at the top of the range

TRAIN_STEPS = 8
UNROUTED_STEPS = 4
K2_PER_STEP = 9
# K1 on the training path: logits (8,128,256,19) -> labels (8,1024,2048)
K1_PATH = (SERVE_BATCH, SERVE_H // 8, SERVE_W // 8, NUM_CLASSES, SERVE_H,
           SERVE_W)
# ragged (n, h, w, c, oh, ow): OW not a multiple of 128, C of 19, 3 and 66;
# x8 across 3 backward spans and 3 bands, both ragged; two forward spans
# whose last run of 8 columns is ragged
K1_RAGGED = ((2, 8, 12, 19, 64, 96), (1, 5, 7, 3, 40, 56),
             (2, 6, 20, 66, 48, 160), (2, 19, 70, 19, 152, 560),
             (1, 4, 130, 19, 32, 1037))
# K2 on the training path, the nine GFE blocks at b8:
# (n, h, w, cin, ce, stride, blocks of this shape)
K2_PATH = ((8, 128, 256, 64, 384, 2, 1), (8, 64, 128, 64, 384, 1, 2),
           (8, 64, 128, 64, 384, 2, 1), (8, 32, 64, 96, 576, 1, 3),
           (8, 32, 64, 128, 768, 1, 2))
# ragged (n, h, w, cin, ce, stride): odd W at stride 1, Ce off the 64-wide
# chunk, odd H and W at stride 2; then shapes whose backward splits Ce over
# groups of chunks (few tiles): Cin 128 and 96, the last chunk ragged at Ce
# 392, Ce off the 8-channel groups at 70 (the plain-load paths)
K2_RAGGED = ((2, 9, 19, 16, 96, 1), (1, 8, 12, 24, 72, 2),
             (2, 7, 13, 12, 40, 2), (2, 8, 16, 128, 768, 1),
             (1, 9, 17, 96, 576, 2), (2, 32, 64, 64, 392, 1),
             (1, 5, 9, 20, 70, 2))
# K6 on the training path, the LDS's stride-2 depthwise convs at b8:
# (name, n, h, w, c, stride)
K6_PATH = (("ds1", 8, 512, 1024, 32, 2), ("ds2", 8, 256, 512, 48, 2))
K6_PER_STEP = len(K6_PATH)
# GFE stage1[0]'s depthwise conv, which routes to K6 in the eval step and
# in the remat step (where no block takes K2), and off every path stride 1
# at the GFE's width; ragged: odd H and W, C of 3, 20 and 384 (off the
# 8-channel groups; GFE stage1[0]'s width)
K6_OFF_STEP = (("stage1[0]", 8, 128, 256, 384, 2),
               ("stride 1", 8, 128, 256, 128, 1))
K6_RAGGED = ((2, 9, 13, 3, 2), (1, 7, 11, 20, 2), (2, 9, 13, 20, 1),
             (2, 6, 10, 384, 2), (1, 5, 9, 384, 1), (3, 37, 53, 40, 2),
             (4, 301, 517, 40, 2), (4, 301, 517, 40, 1))
# K4 on the UNet training path (bilinear decoder, base 64, b8, crop 768):
# (name, n, h, w, cl, cs), low (n,h,w,cl) and skip (n,2h,2w,cs)
K4_PATH = (("up4", 8, 48, 48, 512, 512), ("up3", 8, 96, 96, 256, 256),
           ("up2", 8, 192, 192, 128, 128), ("up1", 8, 384, 384, 64, 64))
K4_PER_FORWARD = len(K4_PATH)
# ragged (n, h, w, cl, cs): Cl != Cs, C of 1, 3 and 5, H = W = 1, odd H and
# W, channels off the 8-channel groups
K4_RAGGED = ((2, 5, 7, 24, 40), (1, 6, 10, 3, 5), (2, 1, 1, 1, 3),
             (1, 9, 13, 5, 1), (1, 4, 6, 64, 8), (2, 7, 9, 16, 16))
UNET_BATCH, UNET_CROP, UNET_LR = 8, 768, 0.045
# K3 on the DeepLab OHEM path: logits (16,48,48,19) at output stride 16 ->
# labels (16,768,768)
DEEPLAB_BATCH, DEEPLAB_CROP, DEEPLAB_LR = 16, 768, 0.01
K3_PATH = (DEEPLAB_BATCH, DEEPLAB_CROP // 16, DEEPLAB_CROP // 16, NUM_CLASSES,
           DEEPLAB_CROP, DEEPLAB_CROP)
# ragged x16 (n, h, w, c, oh, ow), K3's ratio: W under one 16-column tile,
# C of 66 (three class groups) and of 3, W over two of K3's phase-A spans;
# two forward spans whose last run is ragged, and a ragged last band
K3_RAGGED = ((2, 6, 5, 19, 96, 80), (1, 7, 9, 66, 112, 144),
             (1, 3, 2, 3, 48, 32), (1, 4, 90, 19, 64, 1440),
             (2, 5, 21, 66, 80, 336), (1, 5, 66, 19, 84, 1050))
OHEM_THRESH, OHEM_MIN_KEPT = 0.7, 100_000
# BASELINE config 5 (`configs/bisenet_cityscapes_aux.json`): batch 16 of
# 1024x1024 crops, scale 0.75-2.0, SGD lr 0.025, OHEM with aux weight 1.0,
# on the fused-resize route (`upsample_logits=False`): BiSeNet-R18 and
# ICNet-R50, each head through K3
CONFIG5_BATCH, CONFIG5_CROP, CONFIG5_LR = 16, 1024, 0.025
CONFIG5_SCALE = (0.75, 2.0)
CONFIG5_MODELS = (("bisenet", 18), ("icnet", 50))
# K3's launches a step on each path: one head, or the main and two aux heads
K3_PER_STEP = {"deeplab": 1, "bisenet": 3, "icnet": 3}
# K3 at config 5's main heads: BiSeNet's at 1/8 (x8), ICNet's at 1/4 (x4)
K3_PATH_X8 = (CONFIG5_BATCH, CONFIG5_CROP // 8, CONFIG5_CROP // 8,
              NUM_CLASSES, CONFIG5_CROP, CONFIG5_CROP)
K3_PATH_X4 = (CONFIG5_BATCH, CONFIG5_CROP // 4, CONFIG5_CROP // 4,
              NUM_CLASSES, CONFIG5_CROP, CONFIG5_CROP)
# BASELINE config 1 (`configs/enet_cityscapes_512.json`): ENet, batch 4 of
# 512x512 crops, scale 0.5-2.0, SGD lr 0.05, class-weighted CE; no kernel
ENET_BATCH, ENET_CROP, ENET_LR, ENET_SCALE = 4, 512, 0.05, (0.5, 2.0)
# phase 11, the stretch zoo at the zoo benches' configurations: serving as
# `scripts/bench_infer.py:22-44` (batch 8 of 1024x2048, ids out, BN folded,
# no aux heads, 1/8 logits where the constructor takes `upsample_logits`);
# training as `scripts/bench_train_zoo.py` (768x768 crops by
# `augment_batch` from resident 1024x2048 frames, SGD lr 0.045, batch 8 or
# its default 32), LEDNet and ContextNet on the fused-resize route
STRETCH_MODELS = ("erfnet", "esnet", "lednet", "contextnet")
STRETCH_BATCH = {"erfnet": 8, "esnet": 8, "lednet": 8, "contextnet": 32}
STRETCH_LOW_RES = ("lednet", "contextnet")
ZOO_CROP, ZOO_LR = 768, 0.045
# ContextNet's kernel launches: K5 on detail ds3, the FFM and the
# classifier's two pairs; K2 on the context branch's 12 blocks; K6 on the
# detail ds1 and ds2, and in eval on context body[2]'s stride-2 dw conv
# too ((8,128,256,192), on the floor of 2^18 pixels)
CONTEXTNET_K5_PER_REQUEST = 4
CONTEXTNET_K2_PER_STEP = 12
CONTEXTNET_K6_PER_STEP = 2
CONTEXTNET_K6_PER_EVAL_BATCH = 3
# the d(logits) bar of `kernel_vs_plain_step`, relative L2 against the
# plain versions' step; ContextNet's own, set from its recorded readings
# (PERF.md §6): 0.0067-0.0088 in runs whose every launch agreed with its
# plain version within 4.2e-5, where the plain step alone moves
# 0.0069-0.0074 when K2's folded bias is nudged one float32 step (twelve
# blocks of train-mode BN amplify which way a bf16 rounding of the expanded
# tensor falls); 2^-6 is the power of two above the largest reading
DLOGITS_TOL = 2.0 ** -9
STEP_DLOGITS_TOL = {"contextnet": 2.0 ** -6}
# K1 at LEDNet's and ContextNet's training heads: (n, 96, 96, 19) ->
# (n, 768, 768)
K1_ZOO_PATHS = {"lednet": (8, 96, 96, NUM_CLASSES, ZOO_CROP, ZOO_CROP),
                "contextnet": (32, 96, 96, NUM_CLASSES, ZOO_CROP, ZOO_CROP)}
# K2 on ContextNet's training path, the context branch at b32 (its input is
# the crop's x1/4, 192x192; the first conv halves it): (n, h, w, cin, ce,
# stride, blocks of this shape)
K2_PATH_CONTEXTNET = ((32, 96, 96, 32, 32, 1, 1), (32, 96, 96, 32, 192, 1, 1),
                      (32, 96, 96, 32, 192, 2, 1), (32, 48, 48, 48, 288, 1, 2),
                      (32, 48, 48, 48, 288, 2, 1), (32, 24, 24, 64, 384, 1, 3),
                      (32, 24, 24, 96, 576, 1, 2), (32, 24, 24, 128, 768, 1, 1))
# K6 on ContextNet's training path, the detail branch at b32
K6_PATH_CONTEXTNET = (("ds1", 32, 384, 384, 32, 2), ("ds2", 32, 192, 192, 64, 2))
EVAL_BATCHES = 4
# the eval step's K6 launches a batch: in eval mode no block routes to K2,
# so GFE stage1[0]'s depthwise conv, at (8,128,256,384) on the floor of
# 2^18 pixels, routes to K6 beside the LDS's two
K6_PER_EVAL_BATCH = 3
MULTISCALE_BATCH = 2


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
    out["cases"] = {name: r for (name, _, _, _), r in zip(K5_PATH_CASES, rows)}
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
    """K1 forward and backward against the plain version; times at each
    training path's shape: {"fastscnn" | "lednet" | "contextnet": {"fwd":
    ..., "bwd": ...}}."""
    import torch
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
    out = {"fastscnn": k1_path(compare, K1_PATH, 7, "path")}
    for i, (key, shape) in enumerate(K1_ZOO_PATHS.items()):
        out[key] = k1_path(compare, shape, 17 + i, f"{key} path")
        torch.cuda.empty_cache()
    # phase 13's accuracy run: C = 4, the instance for any class count
    out["cli_fused"] = k1_path(compare, K1_PATH_CLI, 23, "cli path")
    return out


def k1_path(compare, shape, seed, name) -> dict:
    """K1 at one path's shape, with and without class weights, and its
    times there (the weighted inputs): {"fwd": ..., "bwd": ...}."""
    import torch
    import torch.nn.functional as F
    from torch_semantic_segmentation_tpu_torch.ops import resize_ce as rce

    n, h, w, c, oh, ow = shape
    errs = []
    for weights in (False, True):
        lerr, derr, args = compare(n, h, w, c, oh, ow, weights, seed, name)
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
        print(f"resize_ce {d} {name} {shape}: kernel_ms {k_ms:.4f} plain_ms "
              f"{p_ms:.4f} library_ms {l_ms:.4f} bound_ms {b[0]:.4f} (bound "
              f"by {b[2]})", flush=True)
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
    shape of the training paths (and ragged ones); per-step times at
    FastSCNN's nine GFE blocks and ContextNet's twelve context blocks:
    {"fastscnn" | "contextnet": {"fwd": ..., "bwd": ...}}."""
    import torch
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
    out = {"fastscnn": k2_path(compare, K2_PATH, 400, "nine GFE blocks")}
    torch.cuda.empty_cache()
    out["contextnet"] = k2_path(compare, K2_PATH_CONTEXTNET, 420,
                                "contextnet's twelve blocks")
    torch.cuda.empty_cache()
    # phase 13's accuracy run: the GFE's maps at 16x16, 8x8 and 4x4
    out["cli"] = k2_path(compare, K2_PATH_CLI, 440,
                         "the accuracy run's nine blocks")
    return out


def k2_path(compare, path, seed, name) -> dict:
    """K2 at each block shape of one training path, and the path's times a
    step: each shape's time times its blocks, summed."""
    import torch
    import torch.nn.functional as F
    from torch_semantic_segmentation_tpu_torch.ops import mbconv

    tot = {key: 0.0 for key in ("fwd_ms", "bwd_ms", "plain_fwd", "plain_bwd",
                                "lib_fwd", "lib_bwd", "lib_bwd_heuristic")}
    fbytes = bbytes = 0.0
    fops = {"tensor": 0.0, "fp32": 0.0}
    bops = {"tensor": 0.0, "fp32": 0.0}
    ferr = berr = 0.0
    for i, (n, h, w, cin, ce, s, count) in enumerate(path):
        fe, be, (x, wt, b, k, g) = compare(n, h, w, cin, ce, s, seed + i,
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
        groups = mbconv._library().mbconv_bwd_groups(n, h, w, cin, ce, s, 0)
        print(f"mbconv path ({n},{h},{w},{cin})x{ce} s{s}: backward over "
              f"{groups} groups of chunks; " + " ".join(
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
        print(f"mbconv {d} {name} a step: kernel_ms {k_ms:.4f} plain_ms "
              f"{p_ms:.4f} library_ms {l_ms:.4f} bound_ms {bd[0]:.4f} (bound "
              f"by {bd[2]})", flush=True)
    print(f"mbconv bwd {name} a step: library_ms on cuDNN's heuristics "
          f"{tot['lib_bwd_heuristic']:.4f}", flush=True)
    return {
        "fwd": dict(err=ferr, kernel_ms=tot["fwd_ms"], plain_ms=tot["plain_fwd"],
                    library_ms=tot["lib_fwd"], bound_ms=fb[0], bound_by=fb[1]),
        "bwd": dict(err=berr, kernel_ms=tot["bwd_ms"], plain_ms=tot["plain_bwd"],
                    library_ms=tot["lib_bwd"], bound_ms=bb[0], bound_by=bb[1])}


def upsample_concat_inputs(n, h, w, cl, cs, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    low = torch.randn((n, h, w, cl), generator=g, device="cuda").to(dtype)
    skip = torch.randn((n, 2 * h, 2 * w, cs), generator=g, device="cuda").to(
        dtype)
    return low, skip


def check_upsample_concat() -> dict:
    """K4 against its plain version, bit for bit, float32 and bf16, at the
    four UpBlock shapes of the UNet training path and at ragged shapes,
    and at each from output row 2 on (the rows a band below the image's
    top asks for, phase 16) against the whole output's rows; per-forward
    times at the path's dtype, bf16: each UpBlock's time, summed over the
    four."""
    import torch
    import torch.nn.functional as F
    from torch_semantic_segmentation_tpu_torch.ops import upsample_concat as uc

    def compare(n, h, w, cl, cs, dtype, seed, name):
        low, skip = upsample_concat_inputs(n, h, w, cl, cs, dtype, seed)
        got = uc.upsample_concat_forward(low, skip)
        want = uc.upsample_concat_reference(low, skip)
        torch.cuda.synchronize()
        same = got.shape == want.shape and got.dtype == want.dtype and bool(
            torch.equal(got, want))
        err = float((got.float() - want.float()).abs().max()) \
            if got.shape == want.shape else float("inf")
        print(f"upsample_concat {name} low ({n},{h},{w},{cl}) skip "
              f"({n},{2 * h},{2 * w},{cs}) {dtype}: max_abs_err {err:.3g}, "
              f"the same bits {same}", flush=True)
        if not same:
            fail(f"upsample_concat {name} {dtype} differs from its plain "
                 "version")
        if h > 2:           # rows [2, 2h - 2), as a band with two halo rows
            band = skip[:, 2:2 * h - 2].contiguous()
            got_b = uc.upsample_concat_forward(low, band, 2)
            want_b = uc.upsample_concat_reference(low, band, 2)
            torch.cuda.synchronize()
            if not (torch.equal(got_b, want_b)
                    and torch.equal(got_b, got[:, 2:2 * h - 2])):
                fail(f"upsample_concat {name} {dtype} from output row 2 "
                     "differs from its plain version or from the whole "
                     "output's rows")
        return err, (low, skip)

    for i, (n, h, w, cl, cs) in enumerate(K4_RAGGED):
        for dtype in (torch.float32, torch.bfloat16):
            compare(n, h, w, cl, cs, dtype, 700 + i, "ragged")
    tot = dict(kernel_ms=0.0, plain_ms=0.0, library_ms=0.0)
    moved = flops = err = 0.0
    for i, (name, n, h, w, cl, cs) in enumerate(K4_PATH):
        for dtype in (torch.float32, torch.bfloat16):
            e, (low, skip) = compare(n, h, w, cl, cs, dtype, 800 + i, name)
            err = max(err, e)
        # yardstick only: ATen's bilinear x2 then cat, channels_last bf16
        low_c, skip_c = low.permute(0, 3, 1, 2), skip.permute(0, 3, 1, 2)

        def library():
            up = F.interpolate(low_c, scale_factor=2, mode="bilinear",
                               align_corners=False)
            return torch.cat((up, skip_c), 1)

        t = dict(kernel_ms=cuda_ms(lambda: uc.upsample_concat_forward(low,
                                                                      skip)),
                 plain_ms=cuda_ms(lambda: uc.upsample_concat_reference(
                     low, skip), iters=3, warmup=1),
                 library_ms=library_ms(library))
        b = 2 * (n * 4 * h * w * (cl + cs) + n * 4 * h * w * cs
                 + n * h * w * cl)
        f = 9 * n * 4 * h * w * cl
        print(f"upsample_concat {name} bf16: " + " ".join(
            f"{k} {v:.4f}" for k, v in t.items())
            + f" bound_ms {bound(b, {'flop': f / FP32_FLOPS})[0]:.4f}",
            flush=True)
        for k in tot:
            tot[k] += t[k]
        moved, flops = moved + b, flops + f
    bd = bound(moved, {"flop": flops / FP32_FLOPS})
    print(f"upsample_concat the four UpBlocks a forward: kernel_ms "
          f"{tot['kernel_ms']:.4f} plain_ms {tot['plain_ms']:.4f} library_ms "
          f"{tot['library_ms']:.4f} bound_ms {bd[0]:.4f} (bound by {bd[2]})",
          flush=True)
    return dict(err=err, bound_ms=bd[0], bound_by=bd[1], **tot)


def check_resize_ce_map() -> dict:
    """K3, the per-pixel map's forward and backward, against the plain
    version at K1's ragged shapes, at its own x16 ones and at the three
    paths' shapes (DeepLab's x16, BiSeNet's x8, ICNet's x4), with K1's
    bars (the map's mean at 1e-4 relative, each element within 1e-5 of the
    map's scale; logz and d(logits) within BF16_TOL of scale); at each
    path a second backward launch gives the same bits, and the times there:
    {"deeplab" | "bisenet" | "icnet": {"fwd": ..., "bwd": ...}}."""
    import torch
    import torch.nn.functional as F
    from torch_semantic_segmentation_tpu_torch.ops import resize_ce as rce

    def compare(n, h, w, c, oh, ow, seed, name):
        logits, labels, _ = resize_ce_inputs(n, h, w, c, oh, ow, seed, False)
        labels = labels.to(torch.int32)       # as `augment_batch` gives them
        g = torch.Generator(device="cuda").manual_seed(seed)
        ct = torch.randn((n, oh, ow), generator=g, device="cuda") * 1e-5
        lmap, logz = rce.resize_ce_map_forward(logits, labels)
        want, want_logz = rce.resize_ce_map_reference(logits, labels)
        dx = rce.resize_ce_map_backward(logits, labels, logz, ct)
        dref = rce.resize_ce_map_reference_backward(logits, labels, logz, ct)
        torch.cuda.synchronize()
        merr = float((lmap - want).abs().max())
        mscale = float(want.abs().max())
        mean_err = abs(float(lmap.mean()) - float(want.mean()))
        zerr = float((logz.float() - want_logz.float()).abs().max())
        zscale = float(want_logz.float().abs().max())
        derr = float((dx.float() - dref.float()).abs().max())
        dscale = float(dref.float().abs().max())
        print(f"resize_ce_map {name} ({n},{h},{w},{c})->({oh},{ow}): map err "
              f"{merr:.3g} (scale {mscale:.3g}, tol 1e-5*scale), mean err "
              f"{mean_err:.3g} (tol 1e-4 rel); logz err {zerr:.3g} (scale "
              f"{zscale:.3g}); d(logits) err {derr:.3g} (scale {dscale:.3g}, "
              f"tol {BF16_TOL:g}*scale)", flush=True)
        if (merr > 1e-5 * mscale or mean_err > 1e-4 * abs(float(want.mean()))
                or zerr > BF16_TOL * zscale or derr > BF16_TOL * dscale
                or lmap.dtype != torch.float32 or dx.dtype != torch.bfloat16
                or bool(lmap[labels == 255].any())):
            fail(f"resize_ce_map {name} disagrees with its plain version")
        return merr, derr, (logits, labels, logz, ct)

    for i, (n, h, w, c, oh, ow) in enumerate(K1_RAGGED + K3_RAGGED):
        compare(n, h, w, c, oh, ow, 900 + i, "ragged")

    def at_path(shape, seed, name):
        """The check at one path shape, two backward launches' bits, and
        the times there."""
        n, h, w, c, oh, ow = shape
        merr, derr, (logits, labels, logz, ct) = compare(*shape, seed, name)
        dx = rce.resize_ce_map_backward(logits, labels, logz, ct)
        if not torch.equal(rce.resize_ce_map_backward(logits, labels, logz,
                                                      ct), dx):
            fail(f"resize_ce_map backward: two launches at {name} differ")
        print(f"resize_ce_map {name}: two backward launches give the same "
              "bits", flush=True)
        del dx
        fwd_ms = cuda_ms(lambda: rce.resize_ce_map_forward(logits, labels))
        bwd_ms = cuda_ms(lambda: rce.resize_ce_map_backward(logits, labels,
                                                            logz, ct))
        plain_fwd = cuda_ms(lambda: rce.resize_ce_map_reference(logits,
                                                                labels),
                            iters=3, warmup=1)
        plain_bwd = cuda_ms(lambda: rce.resize_ce_map_reference_backward(
            logits, labels, logz, ct), iters=3, warmup=1)
        # yardstick only: F.interpolate then the per-pixel F.cross_entropy,
        # and its backward for the cotangent map
        lab = labels.long()
        lg = logits.detach().permute(0, 3, 1, 2).requires_grad_(True)

        def library():
            up = F.interpolate(lg, size=(oh, ow), mode="bilinear",
                               align_corners=False)
            return F.cross_entropy(up.float(), lab, ignore_index=255,
                                   reduction="none")

        with torch.no_grad():
            lib_fwd = library_ms(library, iters=5)
        out = library()
        lib_bwd = library_ms(lambda: torch.autograd.grad(
            out, lg, ct, retain_graph=True), iters=5)
        del out, lab, lg
        px, lab_bytes = n * oh * ow, labels.element_size()
        exps = px * c / EXP_PER_S
        fb = bound(n * h * w * c * 2 + px * (lab_bytes + 4 + 2),
                   {"exp": exps, "flop": (px * c * 4 + n * oh * w * c * 3)
                    / FP32_FLOPS})
        bb = bound(2 * n * h * w * c * 2 + px * (lab_bytes + 2 + 4),
                   {"exp": exps, "flop": (px * c * 10 + n * oh * w * c * 5)
                    / FP32_FLOPS})
        for d, k_ms, p_ms, l_ms, b in (
                ("fwd", fwd_ms, plain_fwd, lib_fwd, fb),
                ("bwd", bwd_ms, plain_bwd, lib_bwd, bb)):
            print(f"resize_ce_map {d} {name} ({n},{h},{w},{c})->({oh},{ow}): "
                  f"kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms "
                  f"{l_ms:.4f} bound_ms {b[0]:.4f} (bound by {b[2]})",
                  flush=True)
        return {
            "fwd": dict(err=merr, kernel_ms=fwd_ms, plain_ms=plain_fwd,
                        library_ms=lib_fwd, bound_ms=fb[0], bound_by=fb[1]),
            "bwd": dict(err=derr, kernel_ms=bwd_ms, plain_ms=plain_bwd,
                        library_ms=lib_bwd, bound_ms=bb[0], bound_by=bb[1])}

    out = {"deeplab": at_path(K3_PATH, 11, "path")}
    torch.cuda.empty_cache()
    for key, shape, seed in (("bisenet", K3_PATH_X8, 12),
                             ("icnet", K3_PATH_X4, 13)):
        out[key] = at_path(shape, seed, f"{key} path x{shape[4] // shape[1]}")
        torch.cuda.empty_cache()
    return out


# a NaN logit through K1 and K3: (n, h, w, c, oh, ow) and the low-res
# elements set to NaN (one on a 16-column tile's edge, one in the first row
# and column, under the ignored top band of labels)
K1_NAN_CASES = (((2, 19, 70, NUM_CLASSES, 152, 560),
                 ((0, 7, 16, 3), (1, 0, 0, 7))),
                (K1_PATH, ((3, 60, 128, 11),)))


def check_resize_ce_nan() -> dict:
    """K1's loss, logz and d(logits) and K3's map, logz and d(logits) with
    NaN logits: NaN exactly where the plain version's are, and every other
    element with the bits of the same launch on the inputs with the NaNs
    set to 0. Returns the NaN elements of each output at each case."""
    import torch
    from torch_semantic_segmentation_tpu_torch.ops import resize_ce as rce

    out = {}
    for (n, h, w, c, oh, ow), nans in K1_NAN_CASES:
        logits, labels, cw = resize_ce_inputs(n, h, w, c, oh, ow, 31, True)
        for i in nans:
            logits[i] = float("nan")
        clean = logits.nan_to_num(0.0)
        counts = {}

        def same(name, got, want, clean_got):
            nan = torch.isnan(got.float())
            counts[name] = int(nan.sum())
            if not torch.equal(nan, torch.isnan(want.float())):
                fail(f"{name} with NaN logits at ({n},{h},{w},{c}): NaN at "
                     f"{int(nan.sum())} elements, the plain version at "
                     f"{int(torch.isnan(want.float()).sum())}")
            if not nan.any() or not torch.equal(got[~nan], clean_got[~nan]):
                fail(f"{name} with NaN logits at ({n},{h},{w},{c}): the "
                     "elements without a NaN moved")

        loss, s2, logz = rce.resize_ce_forward(logits, labels, cw)
        want = rce.resize_ce_reference(logits, labels, cw)
        cl = rce.resize_ce_forward(clean, labels, cw)
        if not (bool(torch.isnan(loss)) and bool(torch.isnan(want[0]))):
            fail(f"K1's loss with NaN logits: {float(loss)}, the plain "
                 f"version's {float(want[0])}")
        same("K1 logz", logz, want[2], cl[2])
        scale = (0.7 / s2).reshape(1)
        same("K1 d(logits)",
             rce.resize_ce_backward(logits, labels, cw, logz, scale),
             rce.resize_ce_reference_backward(logits, labels, cw, logz,
                                              scale),
             rce.resize_ce_backward(clean, labels, cw, cl[2], scale))
        lmap, logz3 = rce.resize_ce_map_forward(logits, labels)
        wmap, wlogz = rce.resize_ce_map_reference(logits, labels)
        cmap, clogz = rce.resize_ce_map_forward(clean, labels)
        same("K3 map", lmap, wmap, cmap)
        same("K3 logz", logz3, wlogz, clogz)
        ct = torch.randn((n, oh, ow), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(5))
        same("K3 d(logits)",
             rce.resize_ce_map_backward(logits, labels, logz3, ct),
             rce.resize_ce_map_reference_backward(logits, labels, logz3, ct),
             rce.resize_ce_map_backward(clean, labels, clogz, ct))
        torch.cuda.synchronize()
        print(f"resize_ce NaN logits ({n},{h},{w},{c})->({oh},{ow}), "
              f"{len(nans)} NaN: K1 loss NaN as the plain version's; NaN "
              f"elements, each as the plain version's, the rest the bits of "
              f"the launch without the NaNs: {counts}", flush=True)
        out[(n, h, w, c, oh, ow)] = counts
        del logits, clean, labels
        torch.cuda.empty_cache()
    return out


def depthwise_inputs(n, h, w, c, stride, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=g, device="cuda").to(dtype)
    k = torch.randn((3, 3, c), generator=g, device="cuda") * 0.5
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    dy = torch.randn((n, ho, wo, c), generator=g, device="cuda").to(dtype)
    return x, k, dy


def depthwise_bwd_plan(n, h, w, c, s) -> str:
    """K6's backward launch plan at stride s, bf16, as the library plans
    it on this card: its blocks (the dk scratch's rows), the tile, threads
    and buffers, the shared memory a block and blocks an SM, the staged
    rows' byte strides and a unit's pixels along W."""
    import ctypes
    from torch_semantic_segmentation_tpu_torch.ops import depthwise as dwm
    out = (ctypes.c_int * 9)()
    rows = dwm._library().dw3x3_backward_plan(n, h, w, c, s, 1, 0,
                                              ctypes.addressof(out))
    names = ("th", "tw", "threads", "buffers", "smem", "per_sm", "xpitch",
             "dpitch", "run")
    return f"blocks {rows}, " + ", ".join(f"{k} {v}" for k, v in
                                          zip(names, out))


def check_depthwise() -> dict:
    """K6 forward and backward against the plain version at the LDS's two
    convs, GFE stage1[0]'s, a stride-1 case and ragged shapes (the last
    stride-2 and stride-1 backward tiles ragged both ways, over few and
    over many tiles a block; the stride-1 backward's plans printed first),
    float32 and bf16: y and dx bit for bit, dk at a relative L2
    error of 1e-5 and the same bits in two launches; per-step times at the
    path's dtype, bf16, each conv's time summed: {"fastscnn" (the LDS's two
    convs) | "contextnet" (the detail branch's two): {"fwd": ..., "bwd":
    ...}}."""
    import torch
    from torch_semantic_segmentation_tpu_torch.ops import depthwise as dwm

    def compare(n, h, w, c, s, dtype, seed, name):
        x, k, dy = depthwise_inputs(n, h, w, c, s, dtype, seed)
        y = dwm.depthwise3x3_forward(x, k, s)
        want = dwm.depthwise3x3_reference(x, k, s)
        dx, dk = dwm.depthwise3x3_backward(x, k, dy, s)
        _, dk2 = dwm.depthwise3x3_backward(x, k, dy, s)
        rdx, rdk = dwm.depthwise3x3_reference_backward(x, k, dy, s)
        torch.cuda.synchronize()
        errs, ok = [], True
        for a, r in ((y, want), (dx, rdx)):
            ok = (ok and a.shape == r.shape and a.dtype == dtype
                  and bool(torch.equal(a, r)))
            errs.append(float((a.float() - r.float()).abs().max()))
        dk_rel = rel_l2(dk, rdk)
        same = bool(torch.equal(dk, dk2))
        print(f"depthwise {name} ({n},{h},{w},{c}) s{s} {dtype}: y err "
              f"{errs[0]:.3g}, dx err {errs[1]:.3g} (both the same bits as "
              f"the plain version); dk rel L2 {dk_rel:.3g} (tol 1e-5), same "
              f"bits in two launches {same}", flush=True)
        if not ok or not dk_rel <= 1e-5 or not same:
            fail(f"depthwise {name} {dtype} disagrees with its plain version "
                 "or dk is not deterministic")
        return errs, (x, k, dy)

    stride1 = [shape[1:] for shape in K6_OFF_STEP if shape[-1] == 1]
    for n, h, w, c, s in stride1 + [r for r in K6_RAGGED if r[-1] == 1]:
        print(f"depthwise stride-1 backward plan ({n},{h},{w},{c}) bf16: "
              f"{depthwise_bwd_plan(n, h, w, c, s)}", flush=True)
    for i, (n, h, w, c, s) in enumerate(K6_RAGGED):
        for dtype in (torch.float32, torch.bfloat16):
            compare(n, h, w, c, s, dtype, 500 + i, "ragged")
    out = {"fastscnn": k6_path(compare, K6_PATH, K6_OFF_STEP, 600,
                               "LDS ds1 + ds2"),
           "contextnet": k6_path(compare, K6_PATH_CONTEXTNET, (), 610,
                                 "contextnet detail ds1 + ds2")}
    torch.cuda.empty_cache()
    return out


def k6_path(compare, path, off_step, seed, name) -> dict:
    """K6 at each conv of one training path (and at `off_step` shapes,
    printed only), float32 and bf16; the path's times a step at bf16, each
    conv's time summed."""
    import torch
    import torch.nn.functional as F
    from torch_semantic_segmentation_tpu_torch.ops import depthwise as dwm

    tot = {key: 0.0 for key in ("fwd_ms", "bwd_ms", "plain_fwd", "plain_bwd",
                                "lib_fwd", "lib_bwd")}
    fbytes = bbytes = fops = bops = 0.0
    ferr = berr = 0.0
    for i, (cname, n, h, w, c, s) in enumerate(path + off_step):
        for dtype in (torch.float32, torch.bfloat16):
            errs, (x, k, dy) = compare(n, h, w, c, s, dtype, seed + i, cname)
        t = dict(
            fwd_ms=cuda_ms(lambda: dwm.depthwise3x3_forward(x, k, s)),
            bwd_ms=cuda_ms(lambda: dwm.depthwise3x3_backward(x, k, dy, s)),
            plain_fwd=cuda_ms(lambda: dwm.depthwise3x3_reference(x, k, s),
                              iters=3, warmup=1),
            plain_bwd=cuda_ms(lambda: dwm.depthwise3x3_reference_backward(
                x, k, dy, s), iters=3, warmup=1))
        # yardstick only: the depthwise conv of ATen / cuDNN in bf16,
        # channels_last, and its autograd backward to x and the kernel
        xc = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
        kc = k.permute(2, 0, 1).unsqueeze(1).to(x.dtype).requires_grad_(True)

        def library():
            return F.conv2d(xc, kc, None, stride=s, padding=1, groups=c)

        with torch.no_grad():
            t["lib_fwd"] = library_ms(library)
        out, gl = library(), dy.permute(0, 3, 1, 2)
        t["lib_bwd"] = library_ms(lambda: torch.autograd.grad(
            out, (xc, kc), gl, retain_graph=True))
        pin, pout = n * h * w * c, dy.numel()
        fb = bound(2 * (pin + pout) + 9 * c * 4,
                   {"flop": 2 * 9 * pout / FP32_FLOPS})
        bb = bound(2 * (2 * pin + pout) + 2 * 9 * c * 4,
                   {"flop": 4 * 9 * pout / FP32_FLOPS})
        print(f"depthwise {cname} ({n},{h},{w},{c}) s{s} bf16: " + " ".join(
            f"{key} {v:.4f}" for key, v in t.items())
            + f" bound_fwd {fb[0]:.4f} bound_bwd {bb[0]:.4f}", flush=True)
        del out, xc, kc, x, dy
        if i >= len(path):
            continue
        ferr, berr = max(ferr, errs[0]), max(berr, errs[1])
        for key in tot:
            tot[key] += t[key]
        fbytes += 2 * (pin + pout) + 9 * c * 4
        bbytes += 2 * (2 * pin + pout) + 2 * 9 * c * 4
        fops += 2 * 9 * pout / FP32_FLOPS
        bops += 4 * 9 * pout / FP32_FLOPS
    fb, bb = bound(fbytes, {"flop": fops}), bound(bbytes, {"flop": bops})
    for d, k_ms, p_ms, l_ms, bd in (
            ("fwd", tot["fwd_ms"], tot["plain_fwd"], tot["lib_fwd"], fb),
            ("bwd", tot["bwd_ms"], tot["plain_bwd"], tot["lib_bwd"], bb)):
        print(f"depthwise {d} {name} a step: kernel_ms {k_ms:.4f} plain_ms "
              f"{p_ms:.4f} library_ms {l_ms:.4f} bound_ms {bd[0]:.4f} (bound "
              f"by {bd[2]})", flush=True)
    return {
        "fwd": dict(err=ferr, kernel_ms=tot["fwd_ms"], plain_ms=tot["plain_fwd"],
                    library_ms=tot["lib_fwd"], bound_ms=fb[0], bound_by=fb[1]),
        "bwd": dict(err=berr, kernel_ms=tot["bwd_ms"], plain_ms=tot["plain_bwd"],
                    library_ms=tot["lib_bwd"], bound_ms=bb[0], bound_by=bb[1])}


def reestimate_bn(model, images):
    """Set every BN's running statistics to the batch statistics of one
    train-mode forward pass over `images` (torch's cumulative average over
    one batch), the rest of the state unchanged."""
    import torch
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
    model.train()
    with torch.no_grad():
        model(images)
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum


# (zoo name, constructor keywords) of the served models
FASTSCNN = ("fastscnn", {"upsample_logits": False})
UNET_BILINEAR = ("unet", {"base_ch": 64, "upsample": "bilinear"})


def calibrated_state(frames, spec=FASTSCNN) -> dict:
    """The model's state from a seed, with BN running stats set by one
    forward pass over two of the frames (as a trained model's statistics
    match its data) and BN affine params drawn from a seed: activations
    keep their scale through the random layers, so the ids vary over the
    image, and folding is not the identity."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        normalize_batch)
    from torch_semantic_segmentation_tpu_torch.models import get_model

    name, kw = spec
    model = get_model(name, NUM_CLASSES, seed=0, device="cuda", **kw)
    calibrate_bn(model, normalize_batch(frames[:2]))
    return {k: v.clone() for k, v in model.state_dict().items()}


def calibrate_bn(model, images):
    """`calibrated_state`'s BN statistics and affine parameters, set on
    `model` in place from one forward pass over `images` (the model in
    eval mode after, no dropout drawn)."""
    import torch
    model.eval()
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None          # cumulative average: one batch sets it
        m.train()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        model(images)
        for m in bns:
            c = m.num_features
            m.weight.copy_(torch.rand(c, generator=g) + 0.5)
            m.bias.copy_(torch.randn(c, generator=g) * 0.2)


def build_model(compute_dtype, state: dict, spec=FASTSCNN):
    import torch
    from torch_semantic_segmentation_tpu_torch.models import get_model
    name, kw = spec
    model = get_model(name, NUM_CLASSES, compute_dtype=compute_dtype,
                      device="cpu", **kw)
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

    fold_check(frames, state, ids)
    return dict(launches=launches, latency_ms=lat_ms)


def fold_check(frames, state: dict, ids, spec=FASTSCNN):
    """float32: the folded (and fused) predictor against the unfolded eval
    model, logits and ids; the served bf16 `ids` against the float32 ids
    are printed, not asserted."""
    import torch
    from torch_semantic_segmentation_tpu_torch.serving import make_predict_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    folded = build_model(None, state, spec)
    unfolded = build_model(None, state, spec)
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
    print(f"serve {spec[0]} f32 folded+fused vs unfolded: logits max_abs_err "
          f"{err:.3g} (scale {scale:.3g}, tol 1e-4*scale + 1e-5); id mismatch "
          f"{mismatch:.3g} (tol 1e-3) over {present} classes present; bf16 "
          f"ids vs f32 unfolded: mismatch {bf16_vs_f32:.3g}", flush=True)
    if present < 2:
        fail("the f32 ids hold one class: the id comparison would be empty")
    if err > 1e-4 * scale + 1e-5:
        fail("folded+fused f32 logits disagree with the unfolded model")
    if mismatch >= 1e-3:
        fail("folded+fused f32 ids disagree with the unfolded model")


# the kernel wrappers of the training paths: (count key, module, wrapper,
# plain version)
TRAIN_WRAPPERS = (
    ("resize_ce_fwd", "resize_ce", "resize_ce_forward", "resize_ce_reference"),
    ("resize_ce_bwd", "resize_ce", "resize_ce_backward",
     "resize_ce_reference_backward"),
    ("mbconv_fwd", "mbconv", "expand_dw_forward", "expand_dw_reference"),
    ("mbconv_bwd", "mbconv", "expand_dw_backward",
     "expand_dw_reference_backward"),
    ("depthwise_fwd", "depthwise", "depthwise3x3_forward",
     "depthwise3x3_reference"),
    ("depthwise_bwd", "depthwise", "depthwise3x3_backward",
     "depthwise3x3_reference_backward"),
    ("upsample_concat", "upsample_concat", "upsample_concat_forward",
     "upsample_concat_reference"),
    ("resize_ce_map_fwd", "resize_ce", "resize_ce_map_forward",
     "resize_ce_map_reference"),
    ("resize_ce_map_bwd", "resize_ce", "resize_ce_map_backward",
     "resize_ce_map_reference_backward"))


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
    """Within the block the autograd functions of K1, K2 and K6 call
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
def k6_unrouted():
    """Within the block no depthwise conv routes to K6: the pixel floor is
    out of reach (a yardstick of this script only)."""
    from torch_semantic_segmentation_tpu_torch.ops import conv
    saved = conv.DEPTHWISE_MIN_PX
    conv.DEPTHWISE_MIN_PX = 1 << 62
    try:
        yield
    finally:
        conv.DEPTHWISE_MIN_PX = saved


def per_step(steps: int, model: str = "fastscnn") -> dict:
    """The launch counts of every kernel in `steps` training steps of
    `model`: FastSCNN launches K1, K2 and K6 (from resident frames or from
    the loader, "fastscnn_pipeline"); UNet's bilinear decoder K4,
    4 a forward; DeepLab with OHEM K3, 1 + 1; BiSeNet and ICNet with OHEM
    on their three heads K3, 3 + 3; LEDNet K1, 1 + 1; ContextNet K1 1 + 1,
    K2 12 + 12 and K6 2 + 2; ENet, ERFNet and ESNet nothing; the train
    CLI's accuracy run at crop 128 ("cli_default", "cli_fused") K2 9 + 9,
    and K1 1 + 1 on the fused route."""
    counts = {key: 0 for key, _, _, _ in TRAIN_WRAPPERS}
    if model == "cli_default":
        counts.update(mbconv_fwd=K2_PER_STEP * steps,
                      mbconv_bwd=K2_PER_STEP * steps)
    elif model == "cli_fused":
        counts.update(resize_ce_fwd=steps, resize_ce_bwd=steps,
                      mbconv_fwd=K2_PER_STEP * steps,
                      mbconv_bwd=K2_PER_STEP * steps)
    elif model in ("fastscnn", "fastscnn_pipeline"):
        counts.update({"resize_ce_fwd": steps, "resize_ce_bwd": steps,
                       "mbconv_fwd": K2_PER_STEP * steps,
                       "mbconv_bwd": K2_PER_STEP * steps,
                       "depthwise_fwd": K6_PER_STEP * steps,
                       "depthwise_bwd": K6_PER_STEP * steps})
    elif model == "lednet":
        counts.update(resize_ce_fwd=steps, resize_ce_bwd=steps)
    elif model == "contextnet":
        counts.update({"resize_ce_fwd": steps, "resize_ce_bwd": steps,
                       "mbconv_fwd": CONTEXTNET_K2_PER_STEP * steps,
                       "mbconv_bwd": CONTEXTNET_K2_PER_STEP * steps,
                       "depthwise_fwd": CONTEXTNET_K6_PER_STEP * steps,
                       "depthwise_bwd": CONTEXTNET_K6_PER_STEP * steps})
    elif model == "unet":
        counts["upsample_concat"] = K4_PER_FORWARD * steps
    elif model in K3_PER_STEP:
        counts.update(resize_ce_map_fwd=K3_PER_STEP[model] * steps,
                      resize_ce_map_bwd=K3_PER_STEP[model] * steps)
    return counts


def timed_steps(step, batches) -> tuple[list, list, int, dict, dict]:
    """Run `step(*batch)` over the batches, each synchronised on the host
    clock, with the launch counts set to 0 just before and read just
    after: (ms a step, losses, peak bytes, launches, {"device_ms": the
    span from a CUDA event before the step to one after it, "enqueue_ms":
    host ms until the step returned, before the synchronisation}). Where
    the enqueue time is close to the step's, the host's launch rate, not
    the card, sets the step's time."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lat, losses, enq, events = [], [], [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        m = step(*batch)
        end.record()
        enq.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
        events.append((start, end))
        losses.append(float(m["loss"]))
    detail = {"device_ms": [a.elapsed_time(b) for a, b in events],
              "enqueue_ms": enq}
    return (lat, losses, torch.cuda.max_memory_allocated(), launch_counts(),
            detail)


def timing_line(lat_ms: list, detail: dict) -> str:
    """Medians of the host clock, the CUDA events' span and the host's
    enqueue time of a run of steps."""
    return (f"median host {np.median(lat_ms):.3f} ms, CUDA events "
            f"{np.median(detail['device_ms']):.3f} ms, enqueue "
            f"{np.median(detail['enqueue_ms']):.3f} ms")


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
    from torch_semantic_segmentation_tpu_torch.ops import mbconv
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
    lat_ms, losses, peak, launches, detail = timed_steps(step, batches[1:])
    print(f"train bf16 {SERVE_BATCH}x{SERVE_H}x{SERVE_W}: losses "
          f"{[round(v, 4) for v in losses]}; step latency_ms "
          f"{[round(t, 3) for t in lat_ms]} {timing_line(lat_ms, detail)}; "
          f"images/s {1e3 * SERVE_BATCH * TRAIN_STEPS / sum(lat_ms):.2f}; "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB; launches "
          f"{launches}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        fail(f"the training loss did not fall: {losses}")
    if launches != per_step(TRAIN_STEPS):
        fail(f"kernel launches in {TRAIN_STEPS} steps: {launches}, expected "
             f"{per_step(TRAIN_STEPS)}")

    # K2 and K6 off the path (yardsticks): the same steps with the nine
    # blocks, or the two LDS depthwise convs, on the plain conv layers
    yard = {}
    for kname, ctx in (("K2", mbconv.suppress_routing), ("K6", k6_unrouted)):
        with ctx():
            step(*batches[0])
            lat_u, _, peak_u, used_u, detail_u = timed_steps(
                step, batches[1:1 + UNROUTED_STEPS])
        print(f"train bf16 without {kname} (on the plain conv layers): step "
              f"latency_ms {[round(t, 3) for t in lat_u]} "
              f"{timing_line(lat_u, detail_u)} (with it "
              f"{timing_line(lat_ms, detail)}); "
              f"max_memory_allocated {peak_u / 2 ** 30:.3f} GiB (with it "
              f"{peak / 2 ** 30:.3f}); launches {used_u}", flush=True)
        key = "mbconv" if kname == "K2" else "depthwise"
        if used_u[f"{key}_fwd"] or used_u[f"{key}_bwd"]:
            fail(f"{kname} launched while unrouted")
        yard[kname] = dict(latency_ms=lat_u, peak_bytes=peak_u)

    grad = grad_check(model, *batches[-1])
    return dict(launches=launches, latency_ms=lat_ms, losses=losses,
                peak_bytes=peak, unrouted=yard, **grad)


def grad_check(model, images, labels) -> dict:
    """The routed bf16 gradient of one step against the float32 step's
    (which runs every kernel's plain version: K1 and K2 take bf16 only, and
    K6 is swapped out), and against the same bf16 step through the kernels'
    plain versions, from the same weights, batch and dropout masks.

    Asserted:
    - the loss within 2e-2 relative of float32's; d(logits) (K1's
      backward) and the head's gradient at cosine 0.99 against float32's;
    - every K1, K2 and K6 launch of the routed step, run again on its own
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
    with swapped(plain_versions):
        l32, d32, g32, used32 = gradient(f32)
    if any(used32.values()) or used16 != per_step(1):
        fail("the bf16 step must launch every kernel and the f32 step none")
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


def train_augmented() -> dict:
    """The main path of the training loop, `bench.py`'s fullres tier at
    batch 8: uint8 frames and labels resident on the card, a fresh
    `augment_batch` draw at crop 1024x2048 with bf16 out before each step,
    then the step (FastSCNN bf16 from a seed, SGD as in `train`)."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        AugmentConfig, augment_batch)
    from torch_semantic_segmentation_tpu_torch.losses import (
        resize_cross_entropy_loss)
    from torch_semantic_segmentation_tpu_torch.models import get_model
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)

    frames, labels = make_batch(200)
    frames = torch.from_numpy(frames).cuda()
    labels = torch.from_numpy(labels).cuda()
    cfg = AugmentConfig(crop=(SERVE_H, SERVE_W), out_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = get_model("fastscnn", NUM_CLASSES, upsample_logits=False,
                      compute_dtype=torch.bfloat16, seed=0, device="cuda")
    state = create_train_state(model, OptimizerConfig(lr=0.045,
                                                      max_steps=1000))
    inner = make_train_step(model, state, resize_cross_entropy_loss)

    def step(raw_images, raw_labels):
        return inner(*augment_batch(raw_images, raw_labels, gen, cfg))

    step(frames, labels)                       # warm-up
    lat_ms, losses, peak, launches, detail = timed_steps(
        step, [(frames, labels)] * TRAIN_STEPS)
    aug_ms = cuda_ms(lambda: augment_batch(frames, labels, gen, cfg),
                     iters=5, warmup=1, reps=3)
    images, lab = augment_batch(frames, labels, gen, cfg)
    torch.cuda.synchronize()
    print(f"train bf16 with augmentation {SERVE_BATCH}x{SERVE_H}x{SERVE_W} "
          f"(main path): losses {[round(v, 4) for v in losses]}; step "
          f"latency_ms {[round(t, 3) for t in lat_ms]} "
          f"{timing_line(lat_ms, detail)}; images/s "
          f"{1e3 * SERVE_BATCH * TRAIN_STEPS / sum(lat_ms):.2f}; "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB; augment_batch "
          f"{aug_ms:.3f} ms a batch; launches {launches}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss with augmentation: {losses}")
    if launches != per_step(TRAIN_STEPS):
        fail(f"kernel launches in {TRAIN_STEPS} augmented steps: {launches}, "
             f"expected {per_step(TRAIN_STEPS)}")
    if (tuple(images.shape) != (SERVE_BATCH, SERVE_H, SERVE_W, 3)
            or images.dtype != torch.bfloat16 or lab.dtype != torch.int32
            or not bool(torch.isfinite(images.float()).all())):
        fail(f"augment_batch gave {tuple(images.shape)} {images.dtype}, "
             f"labels {lab.dtype}")
    return dict(model=model, batch=(images, lab), launches=launches,
                latency_ms=lat_ms, device_ms=detail["device_ms"],
                losses=losses, peak_bytes=peak, augment_ms=aug_ms)


def remat_check(model, images, labels) -> dict:
    """One step with `remat=True` against the same step without remat and
    with K2 suppressed (what the remat step runs inside its checkpoint),
    each from the model's state with a fresh optimizer and the same
    dropout seed, cuDNN restricted to deterministic algorithms in both:
    loss, parameters and running statistics within a relative 1e-6; every
    K6 launch of both steps (GFE stage1[0]'s too, and the recompute's)
    again on its own inputs against the plain version (`check_recorded`).
    Then each step's time and peak memory over 3 steps after a warm-up,
    with cuDNN as the training path runs it."""
    import torch
    from torch_semantic_segmentation_tpu_torch.losses import (
        resize_cross_entropy_loss)
    from torch_semantic_segmentation_tpu_torch.ops import mbconv
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)

    start = {k: v.clone() for k, v in model.state_dict().items()}
    runs, calls = {}, []
    for remat in (False, True):
        model.load_state_dict(start)
        model.dropout_generator.manual_seed(99)
        step = make_train_step(model, create_train_state(
            model, OptimizerConfig(lr=0.045, max_steps=1000)),
            resize_cross_entropy_loss, remat=remat)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            with (contextlib.nullcontext() if remat
                  else mbconv.suppress_routing()), swapped(recording(calls)):
                _, losses, _, used, _ = timed_steps(step, [(images, labels)])
        runs[remat] = dict(loss=losses[0], used=used,
                           state={k: v.clone()
                                  for k, v in model.state_dict().items()})
    worst_launch = check_recorded(calls)
    del calls
    for remat in (False, True):
        model.load_state_dict(start)
        step = make_train_step(model, create_train_state(
            model, OptimizerConfig(lr=0.045, max_steps=1000)),
            resize_cross_entropy_loss, remat=remat)
        with (contextlib.nullcontext() if remat
              else mbconv.suppress_routing()):
            step(images, labels)
            lat, _, peak, _, detail = timed_steps(step, [(images, labels)] * 3)
        runs[remat].update(timed_ms=lat, timed_peak=peak, detail=detail)
    model.load_state_dict(start)
    worst = max((float((runs[True]["state"][k].double()
                        - runs[False]["state"][k].double()).abs().max())
                 / max(float(runs[False]["state"][k].double().abs().max()),
                       1e-30), k)
                for k in start if not k.endswith("num_batches_tracked"))
    loss_rel = abs(runs[True]["loss"] - runs[False]["loss"]) / abs(
        runs[False]["loss"])
    for remat in (False, True):
        r = runs[remat]
        print(f"remat {remat}: loss {r['loss']:.6f}; launches {r['used']}; "
              f"3 steps latency_ms {[round(t, 3) for t in r['timed_ms']]} "
              f"{timing_line(r['timed_ms'], r['detail'])}, "
              f"max_memory_allocated {r['timed_peak'] / 2 ** 30:.3f} GiB",
              flush=True)
    print(f"remat vs K2-suppressed step: loss rel {loss_rel:.3g}; worst "
          f"state tensor {worst[1]} at rel {worst[0]:.3g} (tol 1e-6); each "
          f"kernel launch of both against its plain version on the same inputs: "
          f"worst relative L2 error " + ", ".join(
              f"{k} {v:.3g}" for k, v in worst_launch.items()) + " (tol 2^-9)",
          flush=True)
    plain, rem = runs[False]["used"], runs[True]["used"]
    if plain["mbconv_fwd"] or rem["mbconv_fwd"]:
        fail("K2 launched inside the remat step or under suppress_routing")
    if (rem["depthwise_fwd"] != 2 * plain["depthwise_fwd"]
            or rem["depthwise_bwd"] != plain["depthwise_bwd"]
            or plain["depthwise_fwd"] != K6_PER_STEP + 1):
        fail(f"remat launches {rem}, without remat {plain}: the recompute "
             "should run the forwards again, GFE stage1[0] on K6 too")
    if not loss_rel <= 1e-6 or not worst[0] <= 1e-6:
        fail("the remat step disagrees with the step without remat")
    if not {"depthwise_fwd", "depthwise_bwd"} <= set(worst_launch):
        fail(f"no K6 launch recorded in the remat steps: {worst_launch}")
    return dict(loss_rel=loss_rel, worst_rel=worst[0],
                peak_bytes={str(k): v["timed_peak"] for k, v in runs.items()},
                latency_ms={str(k): v["timed_ms"] for k, v in runs.items()},
                launches={str(k): v["used"] for k, v in runs.items()})


def eval_check(model) -> dict:
    """`make_eval_step` over 4 batches of 8 normalised 1024x2048 frames
    with the trained model (BN unfolded, eval mode), then the multi-scale
    + flip step over one batch of 2: each matrix's total equals the count
    of valid pixels, mIoU lies in [0, 1], each K6 launch of one eval batch
    (the LDS's two and GFE stage1[0]'s) agrees with its plain version on
    its own inputs (`check_recorded`), and the eval step's ids agree with
    the same step through K6's plain version on all but 1e-3 of the
    pixels. Times on CUDA events beside the host clock. After a few steps
    from a seed the running statistics are still far from the
    activations' and every pixel gets one class, so they are first
    re-estimated from two of the frames (`reestimate_bn`)."""
    import torch
    from torch_semantic_segmentation_tpu_torch import metrics
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        normalize_batch)
    from torch_semantic_segmentation_tpu_torch.eval import (
        evaluate, make_multiscale_eval_step)
    from torch_semantic_segmentation_tpu_torch.train import make_eval_step

    batches = []
    for seed in range(EVAL_BATCHES):
        f, lab = make_batch(300 + seed)
        batches.append((normalize_batch(torch.from_numpy(f).cuda(),
                                        out_dtype=torch.bfloat16),
                        torch.from_numpy(lab).cuda()))
    valid = sum(int((lab != 255).sum()) for _, lab in batches)
    reestimate_bn(model, batches[0][0][:2])
    step = make_eval_step(model, num_classes=NUM_CLASSES)
    step(metrics.new_confusion_matrix(NUM_CLASSES), *batches[0])   # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    iou, miou, cm = evaluate(step, batches, num_classes=NUM_CLASSES)
    end.record()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / EVAL_BATCHES
    ev_ms = start.elapsed_time(end) / EVAL_BATCHES
    used = launch_counts()

    # the ids of one batch, through K6 and through its plain version
    ids, calls = {}, []
    real = metrics.update_confusion_matrix
    for name, ctx in (("kernel", lambda: swapped(recording(calls))),
                      ("plain", lambda: swapped(plain_versions))):
        def record(cm_, preds, labels, _name=name, **kw):
            ids[_name] = preds.clone()
            return real(cm_, preds, labels, **kw)
        metrics.update_confusion_matrix = record
        try:
            with ctx():
                step(metrics.new_confusion_matrix(NUM_CLASSES), *batches[0])
        finally:
            metrics.update_confusion_matrix = real
    worst = check_recorded(calls)
    recorded = [args[0].shape for _, _, _, args in calls]
    del calls
    mismatch = float((ids["kernel"] != ids["plain"]).float().mean())
    present = int((torch.bincount(ids["kernel"].flatten().long()) > 0).sum())
    print(f"eval bf16 {EVAL_BATCHES}x{SERVE_BATCH}x{SERVE_H}x{SERVE_W}: "
          f"{ms:.3f} ms a batch on the host clock, {ev_ms:.3f} on CUDA "
          f"events (the matrix read at the end); mIoU {miou:.4f}; matrix "
          f"total {int(cm.sum())} of {valid} valid pixels; launches {used}; "
          f"each K6 launch of one batch against its plain version on the "
          f"same inputs ({[tuple(x) for x in recorded]}): worst relative L2 "
          f"error {worst.get('depthwise_fwd', float('nan')):.3g} (tol 2^-9); "
          f"ids vs K6's plain version: mismatch {mismatch:.3g} (tol 1e-3), "
          f"{present} classes present", flush=True)
    if len(recorded) != K6_PER_EVAL_BATCH or set(worst) != {"depthwise_fwd"}:
        fail(f"one eval batch launched {len(recorded)} K6 forwards and "
             f"{sorted(worst)}, expected {K6_PER_EVAL_BATCH} K6 forwards")
    if int(cm.sum()) != valid or cm.dtype != torch.int64:
        fail("the eval matrix does not hold every valid pixel once")
    if not 0.0 <= miou <= 1.0:
        fail(f"mIoU {miou} out of [0, 1]")
    if used["depthwise_fwd"] != K6_PER_EVAL_BATCH * EVAL_BATCHES or any(
            v for k, v in used.items() if k != "depthwise_fwd"):
        fail(f"eval launches {used}, expected {K6_PER_EVAL_BATCH} K6 "
             "forwards a batch and nothing else")
    if mismatch > 1e-3:
        fail("the eval ids through K6 disagree with its plain version")

    images, labels = batches[0][0][:MULTISCALE_BATCH], \
        batches[0][1][:MULTISCALE_BATCH]
    ms_step = make_multiscale_eval_step(model, num_classes=NUM_CLASSES)
    ms_ms, ms_ev = [], []
    for _ in range(2):                  # the first call picks algorithms
        torch.cuda.synchronize()
        reset_launch_counts()
        start.record()
        t0 = time.perf_counter()
        cm_ms = ms_step(metrics.new_confusion_matrix(NUM_CLASSES), images,
                        labels)
        end.record()
        torch.cuda.synchronize()
        ms_ms.append(1e3 * (time.perf_counter() - t0))
        ms_ev.append(start.elapsed_time(end))
    used_ms = launch_counts()
    _, miou_ms = metrics.iou_from_confusion_matrix(cm_ms)
    want = int((labels != 255).sum())
    print(f"multi-scale + flip eval bf16 {MULTISCALE_BATCH}x{SERVE_H}x"
          f"{SERVE_W}, scales (0.5 .. 1.75): first call {ms_ms[0]:.3f} ms, "
          f"second {ms_ms[1]:.3f} ms on the host clock ({ms_ev[1]:.3f} on "
          f"CUDA events); mIoU {miou_ms:.4f}; matrix total "
          f"{int(cm_ms.sum())} of {want}; launches {used_ms}", flush=True)
    if int(cm_ms.sum()) != want:
        fail("the multi-scale matrix does not hold every valid pixel once")
    return dict(eval_ms=ms, eval_event_ms=ev_ms, miou=miou, launches=used,
                mismatch=mismatch, multiscale_ms=ms_ms,
                multiscale_launches=used_ms)


def request_times(predict, frames, requests: int):
    """Run `predict(frames)` `requests` times, each synchronised: (the last
    output, host ms a request, CUDA-event ms a request)."""
    import torch
    host, dev = [], []
    for _ in range(requests):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = predict(frames)
        end.record()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
        dev.append(start.elapsed_time(end))
    return out, host, dev


def expect_launches(used: dict, want: dict, what: str):
    if used != want:
        fail(f"{what}: kernel launches {used}, expected {want}")


def kernel_vs_plain_step(model, images, labels, loss_fn, name: str,
                         expect: dict,
                         d_tol: float = DLOGITS_TOL) -> dict:
    """One forward and backward of the train step (no update; the model's
    state is put back after) through the kernels, recording each launch,
    then through the kernels' plain versions, with the same dropout
    masks: every recorded launch again on its own inputs against its plain
    version (`check_recorded`, relative L2 2^-9), the launches `expect`
    ({count key: launches}), the loss within 1e-4 relative and d(logits)
    of each output head within relative L2 `d_tol` of the plain versions'
    step (2^-9 unless the model has its own, `STEP_DLOGITS_TOL`).

    Where the step runs K2, the plain step runs once more with K2's folded
    bias nudged by one float32 step (`nudged_plain_versions`, as
    `grad_check` does), and how far that alone moves the plain step's
    d(logits) is printed beside the reading: the measure of how much the
    train-mode BNs amplify which way a bf16 rounding of the expanded
    tensor falls. It is not asserted."""
    import torch

    start = {k: v.clone() for k, v in model.state_dict().items()}

    def gradient():
        model.train()
        model.zero_grad(set_to_none=True)
        gen = getattr(model, "dropout_generator", None)
        if gen is not None:
            gen.manual_seed(1234)
        outputs = model(images)
        heads = (outputs if isinstance(outputs, (tuple, list))
                 else (outputs,))
        for t in heads:
            t.retain_grad()
        loss = loss_fn(outputs, labels)
        loss.backward()
        torch.cuda.synchronize()
        return (float(loss.detach()),
                [t.grad.detach().float() for t in heads])

    calls = []
    with swapped(recording(calls)):
        lk, dk = gradient()
    worst = check_recorded(calls)
    recorded = {}
    for key, _, _, _ in calls:
        recorded[key] = recorded.get(key, 0) + 1
    del calls
    with swapped(plain_versions):
        lp, dp = gradient()
    loss_rel = abs(lk - lp) / abs(lp)
    d_rel = max(rel_l2(a, b) for a, b in zip(dk, dp))
    nudge = None
    if "mbconv_fwd" in recorded:
        with swapped(nudged_plain_versions):
            _, dn = gradient()
        nudge = max(rel_l2(a, b) for a, b in zip(dn, dp))
    model.zero_grad(set_to_none=True)
    model.load_state_dict(start)
    print(f"{name} one step, kernels against plain versions: each launch on "
          f"its own inputs, worst relative L2 error " + ", ".join(
              f"{k} {v:.3g}" for k, v in worst.items())
          + f" (tol 2^-9, launches {recorded}); loss {lk:.6f} vs {lp:.6f} "
          f"(rel {loss_rel:.3g}, tol 1e-4); d(logits) relative L2 "
          f"{d_rel:.3g} (tol {d_tol:.3g}"
          + ("" if nudge is None else f"; the plain step with K2's bias "
             f"nudged one float32 step, not asserted: {nudge:.3g}") + ")",
          flush=True)
    if recorded != expect:
        fail(f"{name}: one step recorded {recorded}, expected {expect}")
    if not loss_rel <= 1e-4 or not d_rel <= d_tol:
        fail(f"{name}: the step through the kernels disagrees with the step "
             "through their plain versions")
    return dict(recorded_rel_l2=worst, loss_rel=loss_rel, dlogits_rel_l2=d_rel,
                dlogits_nudged_rel_l2=nudge)


def eval_batch(model, images, labels, name: str, expect: dict) -> dict:
    """`make_eval_step` over one batch (after a warm-up call), timed on the
    host clock and on CUDA events: the matrix holds every valid pixel once,
    mIoU lies in [0, 1], the launches are `expect`, and each launch of the
    batch runs again on its own inputs against its plain version."""
    import torch
    from torch_semantic_segmentation_tpu_torch import metrics
    from torch_semantic_segmentation_tpu_torch.train import make_eval_step

    step = make_eval_step(model, num_classes=NUM_CLASSES)
    step(metrics.new_confusion_matrix(NUM_CLASSES), images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    cm = step(metrics.new_confusion_matrix(NUM_CLASSES), images, labels)
    end.record()
    torch.cuda.synchronize()
    ms, ev_ms = 1e3 * (time.perf_counter() - t0), start.elapsed_time(end)
    used, peak = launch_counts(), torch.cuda.max_memory_allocated()
    calls = []
    with swapped(recording(calls)):
        step(metrics.new_confusion_matrix(NUM_CLASSES), images, labels)
    worst = check_recorded(calls)
    del calls
    _, miou = metrics.iou_from_confusion_matrix(cm)
    valid = int((labels != 255).sum())
    print(f"{name} eval bf16 one batch {tuple(images.shape[:3])}: {ms:.3f} ms "
          f"on the host clock, {ev_ms:.3f} on CUDA events; images/s "
          f"{1e3 * images.shape[0] / ms:.2f}; max_memory_allocated "
          f"{peak / 2 ** 30:.3f} GiB; mIoU {miou:.4f}; matrix total "
          f"{int(cm.sum())} of {valid}; launches {used}; each launch against "
          f"its plain version on the same inputs: worst relative L2 error "
          f"{worst} (tol 2^-9)", flush=True)
    if int(cm.sum()) != valid or not 0.0 <= miou <= 1.0:
        fail(f"{name} eval: matrix total {int(cm.sum())} of {valid}, mIoU "
             f"{miou}")
    expect_launches(used, expect, f"{name} eval batch")
    return dict(ms=ms, event_ms=ev_ms, miou=miou, launches=used,
                peak_bytes=peak)


def train_run(step, batches, name: str, batch: int, expect: dict) -> dict:
    """A warm-up step and the timed steps: the losses finite and falling
    (the mean of the last three below the first), the launches `expect`."""
    step(*batches[0])
    lat, losses, peak, launches, detail = timed_steps(step, batches)
    print(f"{name}: losses {[round(v, 4) for v in losses]}; step latency_ms "
          f"{[round(t, 3) for t in lat]} {timing_line(lat, detail)}; "
          f"images/s {1e3 * batch * len(lat) / sum(lat):.2f}; "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB; launches "
          f"{launches}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"{name}: non-finite training loss: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        fail(f"{name}: the training loss did not fall: {losses}")
    expect_launches(launches, expect, name)
    return dict(latency_ms=lat, losses=losses, peak_bytes=peak,
                launches=launches, detail=detail)


def unet_phase() -> dict:
    """UNet with the bilinear decoder at full width (base 64, 19 classes,
    bf16 compute, float32 parameters from a seed): serving, training
    through `augment_batch` (the main path of K4), one eval batch; then one
    train step of the deconv decoder."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        AugmentConfig, augment_batch, normalize_batch)
    from torch_semantic_segmentation_tpu_torch.losses import (
        cross_entropy_loss)
    from torch_semantic_segmentation_tpu_torch.models import get_model
    from torch_semantic_segmentation_tpu_torch.serving import make_predict_fn
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)

    out = {}
    frames, labels = (torch.from_numpy(a).cuda() for a in make_batch(500))
    state = calibrated_state(frames, UNET_BILINEAR)
    predict = make_predict_fn(build_model(torch.bfloat16, state,
                                          UNET_BILINEAR), output="ids")
    predict(frames)                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ids, host, dev = request_times(predict, frames, REQUESTS)
    used, peak = launch_counts(), torch.cuda.max_memory_allocated()
    print(f"unet serve bf16 {SERVE_BATCH}x{SERVE_H}x{SERVE_W}: latency_ms "
          f"{[round(t, 3) for t in host]} median host {np.median(host):.3f}, "
          f"CUDA events {np.median(dev):.3f}; frames/s "
          f"{SERVE_BATCH * REQUESTS * 1e3 / sum(host):.2f}; "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB; launches {used}",
          flush=True)
    if (tuple(ids.shape) != (SERVE_BATCH, SERVE_H, SERVE_W)
            or ids.dtype != torch.uint8 or int(ids.max()) >= NUM_CLASSES):
        fail(f"unet ids {tuple(ids.shape)} {ids.dtype}")
    want = per_step(0)
    want["upsample_concat"] = K4_PER_FORWARD * REQUESTS
    expect_launches(used, want, "unet serving")
    fold_check(frames, state, ids, UNET_BILINEAR)
    out["serve"] = dict(latency_ms=host, event_ms=dev, peak_bytes=peak,
                        launches=used)
    del predict, state, ids
    torch.cuda.empty_cache()

    cfg = AugmentConfig(crop=(UNET_CROP, UNET_CROP), out_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = get_model("unet", NUM_CLASSES, base_ch=64, upsample="bilinear",
                      compute_dtype=torch.bfloat16, seed=0, device="cuda")
    inner = make_train_step(model, create_train_state(
        model, OptimizerConfig(lr=UNET_LR, max_steps=1000)),
        cross_entropy_loss)

    def step(raw_images, raw_labels):
        return inner(*augment_batch(raw_images, raw_labels, gen, cfg))

    out["train"] = train_run(
        step, [(frames, labels)] * TRAIN_STEPS,
        f"unet train bf16 {UNET_BATCH}x{UNET_CROP}x{UNET_CROP} with "
        "augmentation (main path of K4)", UNET_BATCH,
        per_step(TRAIN_STEPS, "unet"))
    images, lab = augment_batch(frames, labels, gen, cfg)
    out["check"] = kernel_vs_plain_step(
        model, images, lab, cross_entropy_loss, "unet",
        {"upsample_concat": K4_PER_FORWARD})
    out["eval"] = eval_batch(model, normalize_batch(
        frames, out_dtype=torch.bfloat16), labels, "unet",
        dict(per_step(0), upsample_concat=K4_PER_FORWARD))
    del model, inner, step
    torch.cuda.empty_cache()

    deconv = get_model("unet", NUM_CLASSES, base_ch=64, upsample="deconv",
                       compute_dtype=torch.bfloat16, seed=0, device="cuda")
    dstep = make_train_step(deconv, create_train_state(
        deconv, OptimizerConfig(lr=UNET_LR, max_steps=1000)),
        cross_entropy_loss)
    lat, losses, peak, launches, detail = timed_steps(dstep, [(images, lab)])
    print(f"unet deconv decoder, one train step bf16 {UNET_BATCH}x{UNET_CROP}"
          f"x{UNET_CROP} (the first, cuDNN's set-up included): loss "
          f"{losses[0]:.4f}; {timing_line(lat, detail)}; max_memory_allocated "
          f"{peak / 2 ** 30:.3f} GiB; launches {launches}", flush=True)
    if not np.isfinite(losses[0]):
        fail(f"unet deconv: non-finite loss {losses}")
    expect_launches(launches, per_step(0), "unet deconv step")
    out["deconv"] = dict(latency_ms=lat, loss=losses[0], peak_bytes=peak)
    del deconv, dstep, images, lab
    torch.cuda.empty_cache()
    return out


def deeplab_phase() -> dict:
    """DeepLabV3-ResNet50 with `upsample_logits=False`, bf16 compute:
    training through `augment_batch` with OHEM (the main path of K3) at
    batch 16, or 8 where 16 does not fit; one eval batch."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        AugmentConfig, augment_batch, normalize_batch)
    from torch_semantic_segmentation_tpu_torch.losses import (
        resize_ohem_cross_entropy)
    from torch_semantic_segmentation_tpu_torch.models import get_model
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)

    pairs = [make_batch(600), make_batch(601)]
    frames = torch.from_numpy(np.concatenate([f for f, _ in pairs])).cuda()
    labels = torch.from_numpy(np.concatenate([lb for _, lb in pairs])).cuda()
    loss_fn = functools.partial(resize_ohem_cross_entropy,
                                thresh=OHEM_THRESH, min_kept=OHEM_MIN_KEPT)
    cfg = AugmentConfig(crop=(DEEPLAB_CROP, DEEPLAB_CROP), scale_range=(0.5, 2.0),
                        out_dtype=torch.bfloat16)
    out = {}
    for batch in (DEEPLAB_BATCH, DEEPLAB_BATCH // 2):
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = get_model("deeplabv3_resnet50", NUM_CLASSES,
                          upsample_logits=False, compute_dtype=torch.bfloat16,
                          seed=0, device="cuda")
        inner = make_train_step(model, create_train_state(
            model, OptimizerConfig(lr=DEEPLAB_LR, max_steps=1000)), loss_fn)

        def step(raw_images, raw_labels, _inner=inner, _gen=gen):
            return _inner(*augment_batch(raw_images, raw_labels, _gen, cfg))

        batches = [(frames[:batch], labels[:batch])] * TRAIN_STEPS
        try:
            out["train"] = train_run(
                step, batches, f"deeplabv3_resnet50 train bf16 "
                f"{batch}x{DEEPLAB_CROP}x{DEEPLAB_CROP} with augmentation and "
                f"OHEM (main path of K3)", batch,
                per_step(TRAIN_STEPS, "deeplab"))
            out["batch"] = batch
            break
        except torch.cuda.OutOfMemoryError:
            peak = torch.cuda.max_memory_allocated()
            print(f"deeplabv3_resnet50 batch {batch} does not fit: out of "
                  f"memory at max_memory_allocated {peak / 2 ** 30:.3f} GiB",
                  flush=True)
            del model, inner, step
            torch.cuda.empty_cache()
    else:
        fail("deeplabv3_resnet50 fits neither batch 16 nor batch 8")
    batch = out["batch"]
    images, lab = augment_batch(frames[:batch], labels[:batch], gen, cfg)
    out["check"] = kernel_vs_plain_step(
        model, images, lab, loss_fn, "deeplabv3_resnet50",
        {"resize_ce_map_fwd": 1, "resize_ce_map_bwd": 1})
    del images, lab
    out["eval"] = eval_batch(model, normalize_batch(
        frames[:batch], out_dtype=torch.bfloat16), labels[:batch],
        "deeplabv3_resnet50", per_step(0))
    del model, inner, step
    torch.cuda.empty_cache()
    return out


def config5_loss():
    """config 5's loss, composed as the JAX package's `cli/common.py`
    composes it: OHEM on each head at its own resolution (a `SegLoss`
    that handles the resize, so bf16 heads reach K3), main + 1.0 · aux."""
    from torch_semantic_segmentation_tpu_torch.losses import (
        SegLoss, aux_weighted_loss, resize_ohem_cross_entropy)

    base = SegLoss(functools.partial(
        resize_ohem_cross_entropy, ignore_index=255, thresh=OHEM_THRESH,
        min_kept=OHEM_MIN_KEPT), handles_resize=True, name="resize_ohem")

    def loss_fn(outputs, labels):
        outs = outputs if isinstance(outputs, (tuple, list)) else [outputs]
        return aux_weighted_loss(outs, labels, loss_fn=base, aux_weight=1.0)

    return loss_fn


def multiscale_batch(model, images, labels, name: str) -> dict:
    """`make_multiscale_eval_step` (scales 0.5 .. 1.75 and flip) over one
    batch, called twice (the first call picks algorithms), timed on the
    host clock and on CUDA events: the matrix holds every valid pixel
    once, mIoU lies in [0, 1], and no kernel launches."""
    import torch
    from torch_semantic_segmentation_tpu_torch import metrics
    from torch_semantic_segmentation_tpu_torch.eval import (
        make_multiscale_eval_step)

    step = make_multiscale_eval_step(model, num_classes=NUM_CLASSES)
    host, dev = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        cm = step(metrics.new_confusion_matrix(NUM_CLASSES), images, labels)
        end.record()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
        dev.append(start.elapsed_time(end))
    used, peak = launch_counts(), torch.cuda.max_memory_allocated()
    _, miou = metrics.iou_from_confusion_matrix(cm)
    want = int((labels != 255).sum())
    print(f"{name} multi-scale + flip eval bf16 {tuple(images.shape[:3])}, "
          f"scales (0.5 .. 1.75): first call {host[0]:.3f} ms, second "
          f"{host[1]:.3f} ms on the host clock ({dev[1]:.3f} on CUDA "
          f"events); max_memory_allocated {peak / 2 ** 30:.3f} GiB; mIoU "
          f"{miou:.4f}; matrix total {int(cm.sum())} of {want}; launches "
          f"{used}", flush=True)
    if int(cm.sum()) != want or cm.dtype != torch.int64:
        fail(f"{name}: the multi-scale matrix does not hold every valid "
             "pixel once")
    if not 0.0 <= miou <= 1.0:
        fail(f"{name}: multi-scale mIoU {miou} out of [0, 1]")
    expect_launches(used, per_step(0), f"{name} multi-scale eval")
    return dict(ms=host, event_ms=dev, miou=miou, peak_bytes=peak)


def config5_phase(name: str, depth: int) -> dict:
    """BASELINE config 5 for `name` (BiSeNet or ICNet) on a ResNet-`depth`,
    `upsample_logits=False`, bf16: training through `augment_batch` with
    `aux_weighted_loss` and OHEM (the main path of K3: three heads, at x8,
    x8, x16 for BiSeNet and x4, x8, x16 for ICNet) at batch 16, or 8 where
    16 does not fit; one eval batch at 1024x2048; for BiSeNet, one
    multi-scale + flip batch of 2."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        AugmentConfig, augment_batch, normalize_batch)
    from torch_semantic_segmentation_tpu_torch.models import get_model
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)

    pairs = [make_batch(700), make_batch(701)]
    frames = torch.from_numpy(np.concatenate([f for f, _ in pairs])).cuda()
    labels = torch.from_numpy(np.concatenate([lb for _, lb in pairs])).cuda()
    loss_fn = config5_loss()
    cfg = AugmentConfig(crop=(CONFIG5_CROP, CONFIG5_CROP),
                        scale_range=CONFIG5_SCALE, out_dtype=torch.bfloat16)
    title = f"{name} R{depth}"
    out = {}
    for batch in (CONFIG5_BATCH, CONFIG5_BATCH // 2):
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = get_model(name, NUM_CLASSES, depth=depth,
                          upsample_logits=False, compute_dtype=torch.bfloat16,
                          seed=0, device="cuda")
        inner = make_train_step(model, create_train_state(
            model, OptimizerConfig(lr=CONFIG5_LR, max_steps=1000)), loss_fn)

        def step(raw_images, raw_labels, _inner=inner, _gen=gen):
            return _inner(*augment_batch(raw_images, raw_labels, _gen, cfg))

        batches = [(frames[:batch], labels[:batch])] * TRAIN_STEPS
        try:
            out["train"] = train_run(
                step, batches, f"{title} train bf16 {batch}x{CONFIG5_CROP}x"
                f"{CONFIG5_CROP} with augmentation, aux heads and OHEM "
                "(config 5, main path of K3)", batch,
                per_step(TRAIN_STEPS, name))
            out["batch"] = batch
            break
        except torch.cuda.OutOfMemoryError:
            peak = torch.cuda.max_memory_allocated()
            print(f"{title} batch {batch} does not fit: out of memory at "
                  f"max_memory_allocated {peak / 2 ** 30:.3f} GiB", flush=True)
            del model, inner, step
            torch.cuda.empty_cache()
    else:
        fail(f"{title} fits neither batch 16 nor batch 8")
    batch = out["batch"]
    images, lab = augment_batch(frames[:batch], labels[:batch], gen, cfg)
    k3 = K3_PER_STEP[name]
    out["check"] = kernel_vs_plain_step(
        model, images, lab, loss_fn, title,
        {"resize_ce_map_fwd": k3, "resize_ce_map_bwd": k3})
    del images, lab
    torch.cuda.empty_cache()
    images = normalize_batch(frames[:batch], out_dtype=torch.bfloat16)
    out["eval"] = eval_batch(model, images, labels[:batch], title,
                             per_step(0))
    if name == "bisenet":
        out["multiscale"] = multiscale_batch(
            model, images[:MULTISCALE_BATCH], labels[:MULTISCALE_BATCH],
            title)
    del model, inner, step, images
    torch.cuda.empty_cache()
    return out


def enet_phase() -> dict:
    """BASELINE config 1: ENet, bf16, batch 4 of 512x512 crops through
    `augment_batch` (scale 0.5-2.0), SGD lr 0.05, cross-entropy with ENet's
    class weights from the phase's own label maps
    (`data.class_weights.compute_class_weights`); no kernel launches. One
    eval batch of 4 at 1024x2048."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.class_weights import (
        compute_class_weights)
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        AugmentConfig, augment_batch, normalize_batch)
    from torch_semantic_segmentation_tpu_torch.losses import (
        cross_entropy_loss)
    from torch_semantic_segmentation_tpu_torch.models import get_model
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)

    frames, label_maps = make_batch(800)
    frames, label_maps = frames[:ENET_BATCH], label_maps[:ENET_BATCH]
    cw = compute_class_weights([(None, lb) for lb in label_maps], NUM_CLASSES)
    print(f"enet class weights over the phase's {ENET_BATCH} label maps: "
          f"{[round(float(v), 4) for v in cw]}", flush=True)
    frames, labels = (torch.from_numpy(a).cuda() for a in (frames,
                                                           label_maps))
    loss_fn = functools.partial(cross_entropy_loss,
                                class_weights=torch.from_numpy(cw).cuda())
    cfg = AugmentConfig(crop=(ENET_CROP, ENET_CROP), scale_range=ENET_SCALE,
                        out_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = get_model("enet", NUM_CLASSES, compute_dtype=torch.bfloat16,
                      seed=0, device="cuda")
    inner = make_train_step(model, create_train_state(
        model, OptimizerConfig(lr=ENET_LR, max_steps=1000)), loss_fn)

    def step(raw_images, raw_labels):
        return inner(*augment_batch(raw_images, raw_labels, gen, cfg))

    out = {"train": train_run(
        step, [(frames, labels)] * TRAIN_STEPS,
        f"enet train bf16 {ENET_BATCH}x{ENET_CROP}x{ENET_CROP} with "
        "augmentation and class-weighted CE (config 1)", ENET_BATCH,
        per_step(TRAIN_STEPS, "enet"))}
    images, lab = augment_batch(frames, labels, gen, cfg)
    out["check"] = kernel_vs_plain_step(model, images, lab, loss_fn, "enet",
                                        {})
    out["eval"] = eval_batch(model, normalize_batch(
        frames, out_dtype=torch.bfloat16), labels, "enet", per_step(0))
    del model, inner, step, images, lab
    torch.cuda.empty_cache()
    return out


def stretch_batch(seed: int, batch: int):
    """`batch` frames and label maps on the card, `make_batch` draws of 8."""
    import torch
    pairs = [make_batch(seed + i) for i in range(-(-batch // SERVE_BATCH))]
    frames = np.concatenate([f for f, _ in pairs])[:batch]
    labels = np.concatenate([lb for _, lb in pairs])[:batch]
    return torch.from_numpy(frames).cuda(), torch.from_numpy(labels).cuda()


def stretch_phase(name: str) -> dict:
    """Phase 11 for one stretch model at full width (19 classes, bf16
    compute, float32 parameters from a seed): serve 5 requests at
    `bench_infer.py`'s configuration and hold the folded predictor against
    the unfolded eval model; train 1 + 8 steps through `augment_batch` at
    crop 768 (`bench_train_zoo.py`), the launches read around them; hold
    one step against the plain versions' step and every launch of it on its
    own inputs; one eval batch of 8 at 1024x2048, its launches rechecked;
    for ContextNet, 4 steps with K2 unrouted as a yardstick."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        AugmentConfig, augment_batch, normalize_batch)
    from torch_semantic_segmentation_tpu_torch.losses import (
        cross_entropy_loss, resize_cross_entropy_loss)
    from torch_semantic_segmentation_tpu_torch.models import get_model
    from torch_semantic_segmentation_tpu_torch.ops import mbconv
    from torch_semantic_segmentation_tpu_torch.ops.sepconv import (
        fused_separable_conv)
    from torch_semantic_segmentation_tpu_torch.serving import make_predict_fn
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)

    low_res = name in STRETCH_LOW_RES
    kw = {"upsample_logits": False} if low_res else {}
    spec = (name, dict(kw, aux=False) if name == "contextnet" else kw)
    k5 = CONTEXTNET_K5_PER_REQUEST if name == "contextnet" else 0
    out = {}

    frames, labels = stretch_batch(1000, SERVE_BATCH)
    state = calibrated_state(frames, spec)
    predict = make_predict_fn(build_model(torch.bfloat16, state, spec),
                              output="ids")
    predict(frames)                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    fused_separable_conv.launches = 0
    ids, host, dev = request_times(predict, frames, REQUESTS)
    used, peak = launch_counts(), torch.cuda.max_memory_allocated()
    k5_used = fused_separable_conv.launches
    print(f"{name} serve bf16 {SERVE_BATCH}x{SERVE_H}x{SERVE_W}: latency_ms "
          f"{[round(t, 3) for t in host]} median host {np.median(host):.3f}, "
          f"CUDA events {np.median(dev):.3f}; frames/s "
          f"{SERVE_BATCH * REQUESTS * 1e3 / sum(host):.2f}; "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB; sepconv launches "
          f"{k5_used}; launches {used}", flush=True)
    if (tuple(ids.shape) != (SERVE_BATCH, SERVE_H, SERVE_W)
            or ids.dtype != torch.uint8 or int(ids.max()) >= NUM_CLASSES):
        fail(f"{name} ids {tuple(ids.shape)} {ids.dtype}")
    if k5_used != k5 * REQUESTS:
        fail(f"{name} serving: sepconv launched {k5_used} times in "
             f"{REQUESTS} requests, expected {k5 * REQUESTS}")
    expect_launches(used, per_step(0), f"{name} serving")
    fold_check(frames, state, ids, spec)
    out["serve"] = dict(latency_ms=host, event_ms=dev, peak_bytes=peak,
                        sepconv_launches=k5_used)
    del predict, state, ids
    torch.cuda.empty_cache()

    batch = STRETCH_BATCH[name]
    frames, labels = stretch_batch(1100, batch)
    loss_fn = resize_cross_entropy_loss if low_res else cross_entropy_loss
    cfg = AugmentConfig(crop=(ZOO_CROP, ZOO_CROP), out_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = get_model(name, NUM_CLASSES, compute_dtype=torch.bfloat16, seed=0,
                      device="cuda", **kw)
    inner = make_train_step(model, create_train_state(
        model, OptimizerConfig(lr=ZOO_LR, max_steps=1000)), loss_fn)

    def step(raw_images, raw_labels):
        return inner(*augment_batch(raw_images, raw_labels, gen, cfg))

    out["train"] = train_run(
        step, [(frames, labels)] * TRAIN_STEPS,
        f"{name} train bf16 {batch}x{ZOO_CROP}x{ZOO_CROP} with augmentation"
        f"{' and the fused-resize loss' if low_res else ''} (phase 11)",
        batch, per_step(TRAIN_STEPS, name))
    if name == "contextnet":
        # K2 off the path (a yardstick): the twelve blocks on the plain conv
        # layers; context body[2]'s stride-2 dw conv then routes to K6
        with mbconv.suppress_routing():
            step(frames, labels)
            lat_u, _, peak_u, used_u, detail_u = timed_steps(
                step, [(frames, labels)] * UNROUTED_STEPS)
        lat = out["train"]["latency_ms"]
        print(f"{name} train bf16 without K2 (on the plain conv layers): step "
              f"latency_ms {[round(t, 3) for t in lat_u]} "
              f"{timing_line(lat_u, detail_u)} (with it "
              f"{timing_line(lat, out['train']['detail'])}); "
              f"max_memory_allocated {peak_u / 2 ** 30:.3f} GiB (with it "
              f"{out['train']['peak_bytes'] / 2 ** 30:.3f}); launches "
              f"{used_u}", flush=True)
        if used_u["mbconv_fwd"] or used_u["mbconv_bwd"]:
            fail("K2 launched while unrouted")
        out["unrouted_k2"] = dict(latency_ms=lat_u, detail=detail_u,
                                  peak_bytes=peak_u, launches=used_u)
    images, lab = augment_batch(frames, labels, gen, cfg)
    expect = {k: v for k, v in per_step(1, name).items() if v}
    out["check"] = kernel_vs_plain_step(
        model, images, lab, loss_fn, name, expect,
        STEP_DLOGITS_TOL.get(name, DLOGITS_TOL))
    del images, lab
    torch.cuda.empty_cache()
    frames, labels = frames[:SERVE_BATCH], labels[:SERVE_BATCH]
    want = per_step(0)
    if name == "contextnet":
        want["depthwise_fwd"] = CONTEXTNET_K6_PER_EVAL_BATCH
    out["eval"] = eval_batch(model, normalize_batch(
        frames, out_dtype=torch.bfloat16), labels, name, want)
    del model, inner, step, frames, labels
    torch.cuda.empty_cache()
    return out


# phase 12, training from the host loader: the card's machine has no
# libjpeg or libpng headers (PERF.md §7), so the native loader cannot be
# built there and the phase reads `ShapesDataset` (numpy, no codec) by
# `batch_iterator`'s threads: 24 samples of 1024x2048, 3 batches an epoch,
# so 1 + 8 steps cross two epoch reshuffles
PIPELINE_SAMPLES, PIPELINE_SEED, LOADER_THREADS = 24, 12, 4
LOADER_TIMED_BATCHES = 6
CKPT_STEP = 4
# ShapesDataset's classes as train ids: background road, rectangle car,
# disk person, stripe ignored (the LUT and the ignore label on the path)
SHAPES_LUT = np.full((256,), 255, np.uint8)
SHAPES_LUT[:4] = (0, 13, 11, 255)


def batch_checksums(t) -> list:
    """A position-weighted checksum of each sample of a uint8 batch, the
    same on the card and the host: the sample's bytes as int32 words, each
    times (its index mod 251) + 1, summed in int64."""
    import torch
    words = t.reshape(t.shape[0], -1).view(torch.int32).to(torch.int64)
    w = torch.arange(words.shape[1], device=t.device) % 251 + 1
    return [int(v) for v in (words * w).sum(1)]


def same_tree(a, b, where: str = "") -> list:
    """The paths at which two checkpoint trees differ (tensors bit for
    bit, on the host)."""
    import torch
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        same = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()))
        return [] if same else [where]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{where}: keys {sorted(set(a) ^ set(b))}"]
        return [d for k in a for d in same_tree(a[k], b[k], f"{where}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{where}: lengths {len(a)} and {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in same_tree(x, y, f"{where}/{i}")]
    return [] if a == b else [where]


def pipeline_phase(resident_ms: list) -> dict:
    """FastSCNN's full-width step fed by the port's input path: host
    threads (`batch_iterator` over `ShapesDataset`, the LUT), pinned
    prefetch on a side stream, `augment_batch` at crop 1024x2048, the
    phase-6 step (bf16, SGD lr 0.045), through `train_input_pipeline`; an
    asynchronous checkpoint after 4 steps while the rest run, and a resume
    into fresh objects. `resident_ms`: phase 6's steps on resident frames,
    the yardstick of the e2e rate."""
    import os
    import tempfile

    import torch
    from torch_semantic_segmentation_tpu_torch.checkpoint import (
        CheckpointManager, snapshot)
    from torch_semantic_segmentation_tpu_torch.data.pipeline import (
        batch_iterator, epoch_order, prefetch_to_device, train_input_pipeline)
    from torch_semantic_segmentation_tpu_torch.data.synthetic import (
        ShapesDataset)
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        AugmentConfig, augment_batch)
    from torch_semantic_segmentation_tpu_torch.losses import (
        resize_cross_entropy_loss)
    from torch_semantic_segmentation_tpu_torch.models import get_model
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)

    t_phase = time.perf_counter()
    ds = ShapesDataset(PIPELINE_SAMPLES, SERVE_H, SERVE_W, seed=PIPELINE_SEED)
    loader_kw = dict(seed=PIPELINE_SEED, num_threads=LOADER_THREADS)
    steps = 1 + TRAIN_STEPS

    # the loader alone, 1 + 6 batches as bench.py's e2e tier times its
    # loader; then on to the 9 batches the steps take (the host reference)
    t0 = time.perf_counter()
    host_it = batch_iterator(ds, SERVE_BATCH, label_lut=SHAPES_LUT,
                             **loader_kw)
    host = [next(host_it)]
    t1 = time.perf_counter()
    host += [next(host_it) for _ in range(LOADER_TIMED_BATCHES)]
    t2 = time.perf_counter()
    host += [next(host_it) for _ in range(steps - len(host))]
    loader_rate = SERVE_BATCH * LOADER_TIMED_BATCHES / (t2 - t1)
    cold_rate = SERVE_BATCH * (1 + LOADER_TIMED_BATCHES) / (t2 - t0)
    print(f"loader alone ({LOADER_THREADS} threads of batch_iterator over "
          f"ShapesDataset {SERVE_BATCH}x{SERVE_H}x{SERVE_W}, os.cpu_count() "
          f"{os.cpu_count()}): {loader_rate:.2f} images/s after the first "
          f"batch, {cold_rate:.2f} from the start", flush=True)
    order = epoch_order(PIPELINE_SAMPLES, 0, seed=PIPELINE_SEED)
    raw = [ds[int(i)] for i in order[:SERVE_BATCH]]
    if not (np.array_equal(host[0][0], np.stack([r[0] for r in raw]))
            and np.array_equal(host[0][1],
                               SHAPES_LUT[np.stack([r[1] for r in raw])])):
        fail("batch 0 of the loader is not the samples of epoch_order with "
             "the LUT applied")
    want_sums = [(batch_checksums(torch.from_numpy(i)),
                  batch_checksums(torch.from_numpy(lab))) for i, lab in host]

    # every device batch of the pinned prefetch against its host batch,
    # the consumer's stream lagging (outside the timed steps)
    checked = 0
    for k, (images, labels) in enumerate(prefetch_to_device(batch_iterator(
            ds, SERVE_BATCH, label_lut=SHAPES_LUT, **loader_kw), size=2)):
        if k == steps:
            break
        torch.cuda._sleep(50_000_000)
        if (batch_checksums(images), batch_checksums(labels)) != want_sums[k]:
            fail(f"prefetched batch {k} differs from its host batch")
        checked += 1
    copy_src = torch.from_numpy(host[0][0]).pin_memory()
    copy_dst = torch.empty_like(copy_src, device="cuda")
    copy_ms = cuda_ms(lambda: copy_dst.copy_(copy_src, non_blocking=True),
                      iters=10, warmup=2, reps=3)
    print(f"prefetch: {checked} device batches equal their host batches "
          f"(checksums); a batch's images from pinned memory "
          f"{copy_ms:.3f} ms ({copy_src.numel() / copy_ms / 1e6:.2f} GB/s)",
          flush=True)

    model = get_model("fastscnn", NUM_CLASSES, upsample_logits=False,
                      compute_dtype=torch.bfloat16, seed=0, device="cuda")
    opt = OptimizerConfig(lr=0.045, max_steps=1000)
    state = create_train_state(model, opt)
    step = make_train_step(model, state, resize_cross_entropy_loss)
    gen = torch.Generator(device="cuda").manual_seed(0)
    gens = (gen, model.dropout_generator)
    cfg = AugmentConfig(crop=(SERVE_H, SERVE_W), out_dtype=torch.bfloat16)
    pipe = train_input_pipeline(ds, SERVE_BATCH, cfg, generator=gen,
                                label_lut=SHAPES_LUT, device=None, prefetch=2,
                                **loader_kw)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    mgr = CheckpointManager(ckpt_dir, max_to_keep=2,
                            save_interval_steps=CKPT_STEP)
    step(*next(pipe))                          # warm-up, batch 0
    torch.cuda.synchronize()
    reset_launch_counts()
    lat, events, losses = [], [], []
    for k in range(1, steps):
        if k == CKPT_STEP:    # k batches consumed; saved outside the steps
            torch.cuda.synchronize()
            sync_copy = snapshot(k, model, state, generators=gens)
            ts = time.perf_counter()
            if not mgr.save(k, model, state, generators=gens):
                fail(f"the checkpoint manager skipped step {k}")
            save_ms = 1e3 * (time.perf_counter() - ts)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        images, labels = next(pipe)
        if k == CKPT_STEP:
            kept = (images, labels)            # the uninterrupted draw
        start.record()
        m = step(images, labels)
        end.record()
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
        events.append((start, end))
        losses.append(float(m["loss"]))
    launches = launch_counts()
    t_wait = time.perf_counter()
    mgr.wait()
    wait_ms = 1e3 * (time.perf_counter() - t_wait)
    dev_ms = [a.elapsed_time(b) for a, b in events]
    e2e_rate = 1e3 * SERVE_BATCH * TRAIN_STEPS / sum(lat)
    resident_rate = 1e3 * SERVE_BATCH / float(np.median(resident_ms))
    print(f"train bf16 from the loader {SERVE_BATCH}x{SERVE_H}x{SERVE_W} "
          f"(e2e): losses {[round(v, 4) for v in losses]}; step latency_ms "
          f"(next batch + step, host clock) {[round(t, 3) for t in lat]}, "
          f"median {np.median(lat):.3f}; CUDA events of the step "
          f"{np.median(dev_ms):.3f} ms; e2e images/s {e2e_rate:.2f} against "
          f"phase 6's resident frames {resident_rate:.2f} (median "
          f"{np.median(resident_ms):.3f} ms) and the loader alone "
          f"{loader_rate:.2f}; launches {launches}", flush=True)
    pace = ("the loader" if loader_rate < min(resident_rate,
                                              1e3 * SERVE_BATCH / copy_ms)
            else "the copy" if 1e3 * SERVE_BATCH / copy_ms < resident_rate
            else "the step")
    print(f"pace: {pace} (loader {loader_rate:.2f} images/s, copy "
          f"{1e3 * SERVE_BATCH / copy_ms:.2f}, resident step "
          f"{resident_rate:.2f})", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss from the loader: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        fail(f"the training loss from the loader did not fall: {losses}")
    if launches != per_step(TRAIN_STEPS):
        fail(f"kernel launches in {TRAIN_STEPS} steps from the loader: "
             f"{launches}, expected {per_step(TRAIN_STEPS)}")

    # the checkpoint: what the thread wrote against the synchronous copy
    saved = mgr.load(CKPT_STEP)
    diff = same_tree(saved, sync_copy)
    if diff:
        fail(f"the asynchronous checkpoint differs from the synchronous "
             f"copy at step {CKPT_STEP}: {diff[:5]}")
    fresh = get_model("fastscnn", NUM_CLASSES, upsample_logits=False,
                      compute_dtype=torch.bfloat16, seed=1, device="cuda")
    fresh_state = create_train_state(fresh, opt)
    fresh_gen = torch.Generator(device="cuda").manual_seed(1)
    fresh_gens = (fresh_gen, fresh.dropout_generator)
    if mgr.restore_latest(fresh, fresh_state,
                          generators=fresh_gens) != CKPT_STEP:
        fail("restore_latest did not find the checkpoint")
    diff = same_tree(snapshot(CKPT_STEP, fresh, fresh_state,
                              generators=fresh_gens), sync_copy)
    if diff:
        fail(f"the restored model, optimizer, schedule or generators differ "
             f"from step {CKPT_STEP}'s: {diff[:5]}")
    resumed = next(batch_iterator(ds, SERVE_BATCH, label_lut=SHAPES_LUT,
                                  start_batch=CKPT_STEP, **loader_kw))
    if not all(np.array_equal(a, b) for a, b in zip(resumed,
                                                     host[CKPT_STEP])):
        fail(f"the loader resumed at start_batch={CKPT_STEP} gives another "
             f"batch than the uninterrupted stream's")
    draw = augment_batch(torch.from_numpy(resumed[0]).cuda(),
                         torch.from_numpy(resumed[1]).cuda(), fresh_gen, cfg)
    if not all(torch.equal(a, b) for a, b in zip(draw, kept)):
        fail("the augmentation draw after the resume differs from the "
             "uninterrupted run's")
    fresh_step = make_train_step(fresh, fresh_state,
                                 resize_cross_entropy_loss)
    resumed_loss = float(fresh_step(*draw)["loss"])
    if not np.isfinite(resumed_loss):
        fail(f"the resumed step's loss is {resumed_loss}")
    mgr.close()
    shutil.rmtree(ckpt_dir)
    phase_s = time.perf_counter() - t_phase
    print(f"checkpoint: saved at step {CKPT_STEP} while {TRAIN_STEPS - CKPT_STEP + 1} "
          f"steps ran (save blocked {save_ms:.3f} ms, the write's wait after "
          f"the steps {wait_ms:.3f} ms); equal bit for bit to the "
          f"synchronous copy; restored into a fresh model, optimizer, "
          f"schedule and generators; the loader at start_batch={CKPT_STEP} "
          f"and the next augment_batch draw equal the uninterrupted run's; "
          f"the resumed step's loss {resumed_loss:.4f} (uninterrupted "
          f"{losses[CKPT_STEP - 1]:.4f}); phase {phase_s:.1f} s", flush=True)
    del model, fresh, kept, draw
    torch.cuda.empty_cache()
    return dict(launches=launches, latency_ms=lat, device_ms=dev_ms,
                losses=losses, loader_rate=loader_rate, e2e_rate=e2e_rate,
                copy_ms=copy_ms, phase_s=phase_s)



# phase 13, the CLIs on the card, through their `main(argv)` in process.
# The accuracy recipe of `scripts/make_accuracy_artifact.py:58-63`
# (FastSCNN on `ShapesDataset`'s 4 classes, 16 train samples at the crop,
# batch 8, crop 128, scale 0.75-1.25, SGD lr 0.05, 400 steps, val mIoU
# every 100 over 4 batches) on the default route and with
# `--fused-resize-loss`; the pass mark is the JAX artifact's, 70 val mIoU
# (`ACCURACY_r05.json`). The recipe's flags, its pass mark and the reading
# of the CLI's printed lines live in `scripts/torch_accuracy.py`
# (`accuracy_harness`); the batch, crop and class count below give the
# kernels' shapes in phase 3, and phase 13 holds them to the recipe's.
ACC_BATCH, ACC_CROP, ACC_CLASSES = 8, 128, 4
ACC_RUNS = (("cli_default", ()), ("cli_fused", ("--fused-resize-loss",)))
# K1 on the accuracy run's fused route: logits (8,16,16,4) -> labels
# (8,128,128), the instance for any class count
K1_PATH_CLI = (ACC_BATCH, ACC_CROP // 8, ACC_CROP // 8, ACC_CLASSES, ACC_CROP,
               ACC_CROP)
# K2 on the accuracy run, the nine GFE blocks at crop 128, b8 (the GFE's
# input is the crop's x1/8): (n, h, w, cin, ce, stride, blocks)
K2_PATH_CLI = ((8, 16, 16, 64, 384, 2, 1), (8, 8, 8, 64, 384, 1, 2),
               (8, 8, 8, 64, 384, 2, 1), (8, 4, 4, 96, 576, 1, 3),
               (8, 4, 4, 128, 768, 1, 2))
# predict: 11 val frames at 128x128 in batches of 4 (a padded tail of 3)
# and 2 at 96x160 (a second group), mixed in order
PREDICT_BATCH = 4
PREDICT_WIDE_AT = (3, 8)
# the BASELINE configs through `--config`, on synthetic data at their own
# batch and crop and full width, 2 steps each; UNet's 360x480 crop is
# refused by both packages
CLI_CONFIGS = ("bisenet_cityscapes_aux", "deeplabv3_cityscapes_ohem",
               "enet_cityscapes_512", "fastscnn_cityscapes_fullres")
CONFIG_STEPS = 2


@functools.cache
def accuracy_harness():
    """`scripts/torch_accuracy.py`, loaded by its path beside this file:
    the accuracy recipe (`recipe`, `STEPS`, `EVERY`, `PASS_MARK`), the
    train CLI's printed lines read back (`read_curve`) and `run_cli`."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent / "scripts" / "torch_accuracy.py"
    spec = importlib.util.spec_from_file_location("torch_accuracy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if (mod.BATCH, mod.CROP) != (ACC_BATCH, ACC_CROP):
        fail(f"the accuracy recipe's batch and crop {(mod.BATCH, mod.CROP)} "
             f"are not phase 3's {(ACC_BATCH, ACC_CROP)}")
    return mod


def all_launch_counts() -> dict:
    """The training wrappers' launch counts and K5's."""
    from torch_semantic_segmentation_tpu_torch.ops.sepconv import (
        fused_separable_conv)
    return {**launch_counts(), "sepconv": fused_separable_conv.launches}


def reset_all_launch_counts():
    from torch_semantic_segmentation_tpu_torch.ops.sepconv import (
        fused_separable_conv)
    reset_launch_counts()
    fused_separable_conv.launches = 0


def fastscnn_remat_k6(batch: int, h: int, w: int) -> int:
    """FastSCNN's stride-2 depthwise convs that route to K6 in a remat
    step at batch x h x w: the LDS's ds1 and ds2 (inputs at 1/2 and 1/4)
    and, K2 being off inside the remat segments, GFE stage1[0]'s and
    stage2[0]'s (at 1/8 and 1/16), each where its input holds at least
    `DEPTHWISE_MIN_PX` pixels. Each runs its forward twice a step (the
    recompute) and its backward once."""
    from torch_semantic_segmentation_tpu_torch.ops.conv import (
        DEPTHWISE_MIN_PX)
    return sum(batch * (h // d) * (w // d) >= DEPTHWISE_MIN_PX
               for d in (2, 4, 8, 16))


def read_png(path: str) -> np.ndarray:
    """An 8-bit gray or RGB PNG of filter-0 rows (what the predict CLI's
    `write_png` writes) read back by `zlib`, each chunk's CRC checked."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path} is not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) != int.from_bytes(
                data[pos + 8 + n:pos + 12 + n], "big"):
            fail(f"{path}: bad CRC in {kind}")
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = head[:4]
    ch = {0: 1, 2: 3}[ctype]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * ch)
    if depth != 8 or rows[:, 0].any():
        fail(f"{path}: depth {depth}, filters {set(rows[:, 0].tolist())}")
    return rows[:, 1:].reshape((h, w, ch) if ch == 3 else (h, w))


def cli_step_vs_plain() -> dict:
    """One step of the accuracy run's fused route (FastSCNN, 4 classes,
    bf16, `augment_batch` of 8 `ShapesDataset` frames at crop 128), before
    the run: K1 at C = 4 and K2 at the nine small GFE shapes, every launch
    again on its own inputs against its plain version (`check_recorded`,
    relative L2 2^-9), 1 + 1 K1 and 9 + 9 K2."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.synthetic import (
        ShapesDataset)
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        AugmentConfig, augment_batch)
    from torch_semantic_segmentation_tpu_torch.losses import (
        resize_cross_entropy_loss)
    from torch_semantic_segmentation_tpu_torch.models import get_model

    ds = ShapesDataset(2 * ACC_BATCH, ACC_CROP, ACC_CROP, seed=0)
    frames = torch.from_numpy(np.stack([ds[i][0] for i in range(ACC_BATCH)]))
    labels = torch.from_numpy(np.stack([ds[i][1] for i in range(ACC_BATCH)]))
    images, lab = augment_batch(
        frames.cuda(), labels.cuda(), torch.Generator(
            device="cuda").manual_seed(1),
        AugmentConfig(crop=(ACC_CROP, ACC_CROP), scale_range=(0.75, 1.25),
                      out_dtype=torch.bfloat16))
    model = get_model("fastscnn", ACC_CLASSES, upsample_logits=False,
                      compute_dtype=torch.bfloat16, seed=0, device="cuda")
    model.train()
    calls = []
    with swapped(recording(calls)):
        loss = resize_cross_entropy_loss(model(images), lab)
        loss.backward()
    loss = float(loss.detach())
    worst = check_recorded(calls)
    recorded = {}
    for key, _, _, _ in calls:
        recorded[key] = recorded.get(key, 0) + 1
    print(f"cli fused route, one step at {ACC_BATCH}x{ACC_CROP}x{ACC_CROP}, "
          f"{ACC_CLASSES} classes: loss {loss:.4f}; each launch on "
          f"its own inputs against its plain version: worst relative L2 "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f" (tol 2^-9); launches {recorded}", flush=True)
    want = {"resize_ce_fwd": 1, "resize_ce_bwd": 1,
            "mbconv_fwd": K2_PER_STEP, "mbconv_bwd": K2_PER_STEP}
    if recorded != want or not np.isfinite(loss):
        fail(f"the accuracy run's step launched {recorded}, expected {want}")
    return dict(recorded_rel_l2=worst, launches=recorded)


def accuracy_run(name: str, flags, tmp: str) -> dict:
    """The accuracy recipe through the train CLI: the best val mIoU above
    the pass mark, `<dir>/best` written, the launches `per_step(STEPS,
    name)` (the evals launch nothing: no K2 in eval mode, no K6 under 2^18
    pixels, no K5 on unfolded BN)."""
    import os

    import torch
    from torch_semantic_segmentation_tpu_torch.cli.train import main as train

    acc = accuracy_harness()
    ckpt = os.path.join(tmp, name)
    argv = ["--model", "fastscnn", *acc.recipe(ckpt), *flags]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    t0 = time.perf_counter()
    run, out = acc.run_cli(train, argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    used, peak = all_launch_counts(), torch.cuda.max_memory_allocated()
    curve, rates = acc.read_curve(out)
    best = max((v for _, v in curve), default=float("nan"))
    want = {**per_step(acc.STEPS, name), "sepconv": 0}
    print(f"{name} accuracy run ({' '.join(flags) or 'default route'}): "
          f"eval curve {curve}; best val mIoU {best:.2f} (pass mark "
          f"{acc.PASS_MARK}); the CLI's img/s {rates}; {seconds:.1f} s for "
          f"{acc.STEPS} steps and {len(curve)} evals; max_memory_allocated "
          f"{peak / 2 ** 30:.3f} GiB; launches {used}", flush=True)
    if len(curve) != acc.STEPS // acc.EVERY or not best > acc.PASS_MARK:
        fail(f"{name}: best val mIoU {best} over {curve}, pass mark "
             f"{acc.PASS_MARK}")
    if run.step != acc.STEPS or abs(100 * run.best_miou - best) > 0.005:
        fail(f"{name}: the CLI returned step {run.step}, best "
             f"{run.best_miou}, against its printed {best}")
    if len(os.listdir(os.path.join(ckpt, "best"))) != 1:
        fail(f"{name}: no best checkpoint in {ckpt}/best")
    expect_launches(used, want, f"{name} accuracy run")
    return dict(curve=curve, best=best, img_s=rates, seconds=seconds,
                launches=used, peak_bytes=peak)


def eval_cli_check(best_dir: str) -> dict:
    """The eval CLI on the fused run's best checkpoint (shapes val at
    128x256, batch 4, 2 batches): single-scale above the pass mark, and
    multi-scale + flip (its six default scales); no kernel launches."""
    from torch_semantic_segmentation_tpu_torch.cli.eval import main as evaluate

    mark = accuracy_harness().PASS_MARK
    out = {}
    for mode, extra in (("single", ()), ("multi", ("--multi-scale",))):
        reset_all_launch_counts()
        t0 = time.perf_counter()
        (iou, miou), _ = accuracy_harness().run_cli(evaluate, [
            "--model", "fastscnn", "--dataset", "shapes", "--checkpoint",
            best_dir, "--max-batches", "2", *extra])
        seconds = time.perf_counter() - t0
        used = all_launch_counts()
        print(f"eval CLI {mode}-scale on {best_dir}: mIoU {100 * miou:.2f}, "
              f"per class {[round(100 * float(v), 2) for v in iou]}; {seconds:.1f} "
              f"s; launches {used}", flush=True)
        if not 0.0 <= miou <= 1.0 or (mode == "single"
                                      and not 100 * miou > mark):
            fail(f"eval CLI {mode}-scale mIoU {100 * miou:.2f}, pass mark "
                 f"{mark}")
        expect_launches(used, {k: 0 for k in used}, f"eval CLI {mode}")
        out[mode] = dict(miou=miou, seconds=seconds)
    return out


def predict_check(best_dir: str, tmp: str) -> dict:
    """`predict_frames` on the best checkpoint's model as the predict CLI
    builds it (float32, BN folded, `make_predict_fn`), over 11 val frames
    at 128x128 and 2 at 96x160 in batches of 4, each resolution through
    one `aot_compile`d predictor: the ids equal, bit for bit, the serving
    predictor's called directly on the same batches; 3 K5 launches in each
    of a group's warm-up calls and its capture, none in a replay; the
    masks written by `write_png` and read back by zlib equal the ids, the
    colour masks `palette[ids]`."""
    import os

    import torch
    from torch_semantic_segmentation_tpu_torch.cli.eval import load_weights
    from torch_semantic_segmentation_tpu_torch.cli.predict import (
        auto_palette, predict_frames, write_png)
    from torch_semantic_segmentation_tpu_torch.data.synthetic import (
        ShapesDataset)
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        CITYSCAPES_MEAN, CITYSCAPES_STD)
    from torch_semantic_segmentation_tpu_torch.models import get_model
    from torch_semantic_segmentation_tpu_torch.serving import (
        WARMUP_CALLS, make_predict_fn)

    val = ShapesDataset(11, ACC_CROP, ACC_CROP, seed=10_000)
    wide = ShapesDataset(len(PREDICT_WIDE_AT), 96, 160, seed=10_001)
    samples = [val[i] for i in range(len(val))]
    for j, at in enumerate(PREDICT_WIDE_AT):
        samples.insert(at, wide[j])
    frames = [f for f, _ in samples]
    model = get_model("fastscnn", ACC_CLASSES, seed=0, device="cuda")
    load_weights(model, best_dir)
    predict = make_predict_fn(model, mean=CITYSCAPES_MEAN, std=CITYSCAPES_STD,
                              output="ids")
    groups: dict = {}
    for i, f in enumerate(frames):
        groups.setdefault(f.shape[:2], []).append(i)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        predict(np.stack([frames[0]] * PREDICT_BATCH))      # warm-up
        torch.cuda.synchronize()
        reset_all_launch_counts()
        t0 = time.perf_counter()
        ids = predict_frames(predict, frames, PREDICT_BATCH)
        ms = 1e3 * (time.perf_counter() - t0)
        used = all_launch_counts()
        direct = [None] * len(frames)
        batches = 0
        for idxs in groups.values():
            for lo in range(0, len(idxs), PREDICT_BATCH):
                chunk = idxs[lo:lo + PREDICT_BATCH]
                pad = [chunk[-1]] * (PREDICT_BATCH - len(chunk))
                out = predict(np.stack([frames[i] for i in chunk + pad]))
                batches += 1
                for j, i in enumerate(chunk):
                    direct[i] = out[j].cpu().numpy()
    same = all(a.dtype == np.uint8 and np.array_equal(a, b)
               for a, b in zip(ids, direct, strict=True))
    acc = float(np.mean([(a == lab).mean() for a, (_, lab)
                         in zip(ids, samples)]))
    palette = auto_palette(ACC_CLASSES)
    written = 0
    for i, a in enumerate(ids):
        for suffix, img in (("ids", a), ("color", palette[a])):
            path = os.path.join(tmp, f"f{i}_{suffix}.png")
            write_png(path, img)
            if not np.array_equal(read_png(path), img):
                fail(f"{path} does not read back as the array written")
            written += 1
    # each group's compile: its warm-up calls and its capture; its batches
    # replay the graph, which no wrapper counts
    want = {**{k: 0 for k in launch_counts()},
            "sepconv": K5_PER_REQUEST * (WARMUP_CALLS + 1) * len(groups)}
    print(f"predict_frames: {len(frames)} frames ({len(groups)} groups, "
          f"{batches} batches of {PREDICT_BATCH}, one compiled predictor a "
          f"group) in {ms:.1f} ms, compiles included; ids equal the direct "
          f"predictor's bit for bit: {same}; pixel accuracy against the "
          f"labels {acc:.4f}; {written} PNGs read back equal; launches "
          f"{used}", flush=True)
    if not same:
        fail("predict_frames' ids differ from the serving predictor's")
    expect_launches(used, want, "predict_frames")
    return dict(ms=ms, pixel_accuracy=acc, launches=used)


# the arguments of a launch that hold the batch, and the images in each
# slice of it, where `config_step_vs_plain` runs a plain version over
# slices of the batch
BATCH_ARGS = {"resize_ce_fwd": (0, 1), "resize_ce_bwd": (0, 1, 3),
              "depthwise_fwd": (0,), "depthwise_bwd": (0, 2)}
PLAIN_SLICE = 16


def batch_sliced(key: str, plain):
    """`plain` over slices of `PLAIN_SLICE` images of the batch, joined
    into the whole batch's outputs: logz, y, dx and d(logits) by
    concatenation, K6's dk and K1's S₂ by their sum, K1's loss as the
    S₂-weighted mean of the slices'. The plain versions at FastSCNN's
    fullres config (b128 of 1024x1024) would otherwise take tens of GiB:
    K1's backward holds several float32 (128,1024,1024,19) tensors."""
    import torch
    if key not in BATCH_ARGS:
        fail(f"no batch slicing for {key}")

    def call(*args):
        parts = []
        for lo in range(0, args[0].shape[0], PLAIN_SLICE):
            parts.append(plain(*(a[lo:lo + PLAIN_SLICE]
                                 if i in BATCH_ARGS[key] else a
                                 for i, a in enumerate(args))))
        if key == "resize_ce_fwd":
            s2 = torch.stack([p[1] for p in parts]).sum()
            loss = torch.stack([p[0] * p[1] for p in parts]).sum() / s2
            return loss, s2, torch.cat([p[2] for p in parts])
        if key == "depthwise_bwd":
            return (torch.cat([p[0] for p in parts]),
                    torch.stack([p[1] for p in parts]).sum(dim=0))
        return torch.cat(parts)
    return call


def config_step_vs_plain(name: str, path, want: dict) -> dict:
    """One step of config `name` through the train CLI (`--config path
    --dataset synthetic --max-iterations 1`) with every kernel launch
    recorded, then each launch again on its own inputs against its plain
    version over slices of the batch (`check_recorded`, relative L2 2^-9):
    the launches of a step at the largest shapes the kernels run on the
    card. The recorded launches must be `want`."""
    import torch
    from torch_semantic_segmentation_tpu_torch.cli.train import main as train

    calls = []
    t0 = time.perf_counter()
    with swapped(recording(calls)):
        text = accuracy_harness().run_cli(train, [
            "--config", str(path), "--dataset", "synthetic",
            "--max-iterations", "1", "--log-every", "1"])[1]
    recorded = {key: 0 for key in want}
    for key, _, _, _ in calls:
        recorded[key] = recorded.get(key, 0) + 1
    shapes = sorted({(key, tuple(args[0].shape)) for key, _, _, args in calls})
    worst = check_recorded([(key, fn, batch_sliced(key, plain), args)
                            for key, fn, plain, args in calls])
    del calls
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    losses = [float(m.group(1)) for m in re.finditer(
        r"it \d+/\d+ loss ([-\d.naif]+)", text)]
    print(f"config {name}, one step with each launch on its own inputs "
          f"against its plain version (over slices of {PLAIN_SLICE} "
          f"images): loss {losses}; worst relative L2 "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f" (tol 2^-9); launches {recorded}; first inputs {shapes}; "
          f"{seconds:.1f} s", flush=True)
    if len(losses) != 1 or not np.isfinite(losses[0]):
        fail(f"config {name}, the recorded step: losses {losses}")
    expect_launches(recorded, want, f"config {name}, the recorded step")
    return dict(recorded_rel_l2=worst, launches=recorded, seconds=seconds)


def config_runs(remat_launches: dict) -> dict:
    """Each of `CLI_CONFIGS` through `--config configs/<c>.json --dataset
    synthetic --max-iterations 2`, at its batch and crop: finite losses,
    the expected launches (none but the fullres config's: K1 1 + 1 a step,
    K6 `fastscnn_remat_k6` twice forward and once backward a step, no K2
    under remat; the count is first held against phase 6's remat step),
    the peak memory; then one more step of the fullres config with each
    launch held against its plain version (`config_step_vs_plain`), apart
    from the measured run so that its recording does not raise the peak;
    `unet_camvid` raises UNet's divisibility error."""
    from pathlib import Path

    import torch
    from torch_semantic_segmentation_tpu_torch.cli.train import main as train

    configs = Path(__file__).resolve().parent / "configs"
    k6_phase6 = fastscnn_remat_k6(SERVE_BATCH, SERVE_H, SERVE_W)
    if (remat_launches["depthwise_bwd"] != k6_phase6
            or remat_launches["depthwise_fwd"] != 2 * k6_phase6):
        fail(f"phase 6's remat step launched {remat_launches}, against "
             f"{k6_phase6} routed convs by fastscnn_remat_k6")
    out = {}
    for name in CLI_CONFIGS:
        with open(configs / f"{name}.json") as f:
            cfg = json.load(f)
        batch = cfg["batch_size"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launch_counts()
        t0 = time.perf_counter()
        text = accuracy_harness().run_cli(train, [
            "--config", str(configs / f"{name}.json"), "--dataset",
            "synthetic", "--max-iterations", str(CONFIG_STEPS),
            "--log-every", "1"])[1]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        used, peak = all_launch_counts(), torch.cuda.max_memory_allocated()
        losses = [float(m.group(1)) for m in re.finditer(
            r"it \d+/\d+ loss ([-\d.naif]+)", text)]
        want = {k: 0 for k in used}
        if name == "fastscnn_cityscapes_fullres":
            k6 = fastscnn_remat_k6(batch, *cfg["crop_size"])
            want.update(resize_ce_fwd=CONFIG_STEPS, resize_ce_bwd=CONFIG_STEPS,
                        depthwise_fwd=2 * k6 * CONFIG_STEPS,
                        depthwise_bwd=k6 * CONFIG_STEPS)
        crop = "x".join(map(str, cfg["crop_size"]))
        print(f"config {name} (batch {batch}, crop "
              f"{crop}): losses {losses}; {seconds:.1f} s with the build and "
              f"the data; max_memory_allocated {peak / 2 ** 30:.3f} GiB; "
              f"launches {used}", flush=True)
        if len(losses) != CONFIG_STEPS or not all(np.isfinite(losses)):
            fail(f"config {name}: losses {losses}")
        expect_launches(used, want, f"config {name}")
        out[name] = dict(batch=batch, losses=losses, peak_bytes=peak,
                         launches=used, seconds=seconds)
        torch.cuda.empty_cache()
        if name == "fastscnn_cityscapes_fullres":
            out[name]["step_vs_plain"] = config_step_vs_plain(
                name, configs / f"{name}.json",
                {k: v // CONFIG_STEPS for k, v in want.items()
                 if k != "sepconv"})
    try:
        train(["--config", str(configs / "unet_camvid.json"), "--dataset",
               "synthetic", "--max-iterations", "1"])
    except ValueError as e:
        if "divisible by 16" not in str(e):
            raise
        print(f"config unet_camvid refused: {e}", flush=True)
    else:
        fail("config unet_camvid trained at its 360x480 crop")
    return out


def cli_phase(remat_launches: dict) -> dict:
    """Phase 13: the train, eval and predict CLIs on the card."""
    import tempfile

    t_phase = time.perf_counter()
    step = cli_step_vs_plain()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        runs = {name: accuracy_run(name, flags, tmp)
                for name, flags in ACC_RUNS}
        best_dir = f"{tmp}/cli_fused/best"
        evals = eval_cli_check(best_dir)
        predicted = predict_check(best_dir, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    configs = config_runs(remat_launches)
    phase_s = time.perf_counter() - t_phase
    print(f"phase 13 (the CLIs): {phase_s:.1f} s", flush=True)
    return dict(step=step, runs=runs, evals=evals, predict=predicted,
                configs=configs, phase_s=phase_s)


# phase 14, the data-parallel path. The two-rank CLI run's bars, set before
# any run: step 1's loss within 1e-4 relative of the single process's (the
# two runs differ only in the order of the sums), steps 2-3 within 1e-3
DP_STEP1_RTOL, DP_LATER_RTOL = 1e-4, 1e-3
# the group of one with K2 routed: its largest gap to the step without a
# group against the largest between two runs without one, each step (set
# from a reading of 0.00448 against 0.00375 at step 1, PERF.md §6)
DP_ROUTED_NOISE = 4.0
DP_CLI_FLAGS = ["--dataset", "synthetic", "--model", "fastscnn",
                "--batch-size", "8", "--crop-size", "1024", "2048",
                "--fused-resize-loss", "--max-iterations", "3",
                "--log-every", "1"]
DP_CLI_STEPS = 3
# a rank of the two-rank run: the train CLI's main in a process of its own,
# then its logged losses and its kernel launches
DP_RANK_SCRIPT = (
    "import json, sys\n"
    "from torch_semantic_segmentation_tpu_torch.cli.train import main\n"
    "from torch_semantic_segmentation_tpu_torch.profiling import "
    "launch_counts\n"
    "run = main(sys.argv[1:])\n"
    "print('RANK_RESULT ' + json.dumps({'losses': run.losses, "
    "'launches': launch_counts()}), flush=True)\n")
# `profiling.measure` of phase 6's step against the spread of the same
# step timed as phase 6 times it, synchronised (host clock): back to back,
# one step's enqueue overlaps the last one's tail, which synchronised steps
# do not, so the band reaches 20% below the fastest and 10% above the
# slowest
MEASURE_BAND = (0.8, 1.1)
# FastSCNN's kernels as a Chrome trace names them
TRACE_KERNELS = {"K1": ("resize_ce_fwd_runs", "resize_ce_bwd_mma"),
                 "K2": ("mbconv_fwd_kernel", "mbconv_bwd_kernel"),
                 "K6": ("dw_fwd_kernel", "dw_bwd_s2_kernel")}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase6_setup():
    """Phase 6's configuration: FastSCNN bf16 from seed 0 on the
    fused-resize route, resident uint8 frames of 1024x2048, and the
    augmentation at crop 1024x2048 with bf16 out."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        AugmentConfig)
    from torch_semantic_segmentation_tpu_torch.models import get_model
    frames, labels = make_batch(200)
    model = get_model("fastscnn", NUM_CLASSES, upsample_logits=False,
                      compute_dtype=torch.bfloat16, seed=0, device="cuda")
    return (model, torch.from_numpy(frames).cuda(),
            torch.from_numpy(labels).cuda(),
            AugmentConfig(crop=(SERVE_H, SERVE_W), out_dtype=torch.bfloat16))


def phase6_step(model, cfg, seed: int = 0):
    """Phase 6's step on raw frames: a fresh SGD state and augmentation
    generator, then `augment_batch` and the train step. Returns (step,
    the inner train step, the train state, the generator)."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        augment_batch)
    from torch_semantic_segmentation_tpu_torch.losses import (
        resize_cross_entropy_loss)
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = create_train_state(model, OptimizerConfig(lr=0.045,
                                                      max_steps=1000))
    inner = make_train_step(model, state, resize_cross_entropy_loss)

    def step(raw_images, raw_labels):
        return inner(*augment_batch(raw_images, raw_labels, gen, cfg))
    return step, inner, state, gen


def two_steps(model, start: dict, frames, labels, cfg, routed: bool) -> dict:
    """Two of phase 6's steps from `start`, cuDNN on deterministic
    algorithms, K2 routed or not (its backward sums with atomics, so a
    routed step varies from run to run): the losses and the state dict
    after each."""
    import torch
    from torch_semantic_segmentation_tpu_torch.ops import mbconv
    model.load_state_dict(start)
    model.dropout_generator.manual_seed(99)
    step = phase6_step(model, cfg)[0]
    out = {"losses": [], "states": []}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False), \
            (contextlib.nullcontext() if routed
             else mbconv.suppress_routing()):
        for _ in range(2):
            out["losses"].append(step(frames, labels)["loss"].clone())
            out["states"].append({k: v.clone()
                                  for k, v in model.state_dict().items()})
    return out


def gaps(a: dict, b: dict) -> list:
    """[(step, tensor, max |a − b|)] of every loss and state tensor that
    two `two_steps` runs do not share bit for bit, in step order."""
    import torch
    out = []
    for i in range(2):
        if not torch.equal(a["losses"][i], b["losses"][i]):
            out.append((i + 1, "loss", float(
                (a["losses"][i] - b["losses"][i]).abs())))
        for k, v in a["states"][i].items():
            w = b["states"][i][k]
            if not torch.equal(v, w):
                out.append((i + 1, k, float((v.double() - w.double())
                                            .abs().max())))
    return out


def eval_matrix(model, start: dict, batches):
    """`evaluate` of the eval step over `batches` with the `start`
    state: the int64 matrix."""
    from torch_semantic_segmentation_tpu_torch.eval import evaluate
    from torch_semantic_segmentation_tpu_torch.train import make_eval_step
    model.load_state_dict(start)
    step = make_eval_step(model, num_classes=NUM_CLASSES)
    return evaluate(step, batches, num_classes=NUM_CLASSES)[2]


def compare_runs(plain_a: dict, plain_b: dict, grouped: dict,
                 what: str, strict: bool) -> None:
    """The group's two steps against the same steps without a group, the
    first loss bit for bit. `strict`: bit for bit wherever two runs
    without a group agree. Otherwise (K2 routed: which tensors its
    atomics leave alike in two runs is chance) the gap is printed with the
    tensor it enters at, and each step's largest gap must stay within
    `DP_ROUTED_NOISE` times the largest between two runs without a
    group."""
    import torch
    noise = gaps(plain_a, plain_b)
    gap = gaps(plain_a, grouped)
    unstable = {(s, k) for s, k, _ in noise}
    beyond = [g for g in gap if (g[0], g[1]) not in unstable]
    worst = max((g[2] for g in gap), default=0.0)
    worst_noise = max((g[2] for g in noise), default=0.0)
    print(f"dp group of one, {what}: two steps against the same steps "
          f"without a group: "
          + ("bit for bit" if not gap else
             f"not bit for bit at {len(gap)} tensors, the gap enters at step "
             f"{gap[0][0]} in {gap[0][1]} (max |diff| {gap[0][2]:.3g}, "
             f"{worst:.3g} over all); two runs without a group differ at "
             f"{len(noise)} tensors"
             + (f", first at step {noise[0][0]} in {noise[0][1]} (max |diff| "
                f"{noise[0][2]:.3g}, {worst_noise:.3g} over all)"
                if noise else "")), flush=True)
    if strict and beyond:
        fail(f"the group of one ({what}) differs where runs without a group "
             f"agree: {beyond[:5]}")
    for step in (1, 2):
        g = max((d for s_, _, d in gap if s_ == step), default=0.0)
        n = max((d for s_, _, d in noise if s_ == step), default=0.0)
        if not strict and g > DP_ROUTED_NOISE * n:
            fail(f"the group of one ({what}) moves step {step} by {g:.3g}, "
                 f"two runs without a group differ by {n:.3g}")
    if not torch.equal(plain_a["losses"][0], grouped["losses"][0]):
        fail(f"the group of one's first loss ({what}) differs from the step "
             "without a group")


def group_of_one(main_path: dict) -> dict:
    """A NCCL group of one in this process, on phase 6's configuration:
    two steps held against the same two steps without a group, with K2
    unrouted (every kernel left is deterministic, so bit for bit) and
    routed (`compare_runs`); 1 + 8 timed steps with the launches checked,
    the collectives a step counted and one collective's host time; 2 eval
    batches whose matrix equals the matrix without a group."""
    import os
    import torch
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        normalize_batch)
    from torch_semantic_segmentation_tpu_torch.parallel import distributed

    model, frames, labels, cfg = phase6_setup()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batches = []
    for seed in range(2):
        f, lab = make_batch(300 + seed)
        batches.append((normalize_batch(torch.from_numpy(f).cuda(),
                                        out_dtype=torch.bfloat16),
                        torch.from_numpy(lab).cuda()))
    plain = {routed: [two_steps(model, start, frames, labels, cfg, routed)
                      for _ in range(2)] for routed in (False, True)}
    cm_plain = eval_matrix(model, start, batches)
    step = phase6_step(model, cfg)[0]
    step(frames, labels)                       # warm-up
    base = timed_steps(step, [(frames, labels)] * TRAIN_STEPS)[4]

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    dev = distributed.initialize()
    if torch.distributed.get_backend() != "nccl" or dev.type != "cuda":
        fail(f"the group of one runs {torch.distributed.get_backend()} on "
             f"{dev}")
    grouped = {routed: two_steps(model, start, frames, labels, cfg, routed)
               for routed in (False, True)}
    probe = torch.zeros((2, 128), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        distributed.reduce_sum(probe)
    one_ms = 10 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    sync_ms = 10 * (time.perf_counter() - t0)

    step = phase6_step(model, cfg)[0]
    step(frames, labels)                       # warm-up
    count0 = distributed.collectives
    lat_ms, losses, peak, launches, detail = timed_steps(
        step, [(frames, labels)] * TRAIN_STEPS)
    collectives = (distributed.collectives - count0) / TRAIN_STEPS
    # where the group's extra host time goes: one step under the profiler,
    # the operations with the most host time of their own
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(frames, labels)
        torch.cuda.synchronize()
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print("dp group of one, one step's host time by operation: " + "; ".join(
        f"{e.key} {e.self_cpu_time_total / 1e3:.2f} ms x{e.count}"
        for e in top[:8]), flush=True)
    cm_group = eval_matrix(model, start, batches)
    distributed.destroy()
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        os.environ.pop(k)

    for routed, what in ((False, "K2 unrouted"), (True, "K2 routed")):
        compare_runs(*plain[routed], grouped[routed], what, strict=not routed)
    phase6_dev = float(np.median(main_path["device_ms"]))
    base_dev = float(np.median(base["device_ms"]))
    print(f"dp group of one: losses {[round(v, 4) for v in losses]}; step "
          f"latency_ms {[round(t, 3) for t in lat_ms]} "
          f"{timing_line(lat_ms, detail)}; the step without a group just "
          f"before: CUDA events {base_dev:.3f} ms (phase 6's own run "
          f"{phase6_dev:.3f} ms); collectives a step {collectives:g}, one "
          f"{one_ms:.3f} ms of host time ({sync_ms:.3f} ms to the card's "
          f"end, 100 in a row); "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB; eval matrix "
          f"{'equal' if torch.equal(cm_plain, cm_group) else 'DIFFERENT'} "
          f"({int(cm_group.sum())} pixels)", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"non-finite loss in the group of one: {losses}")
    if launches != per_step(TRAIN_STEPS):
        fail(f"kernel launches in {TRAIN_STEPS} steps of the group of one: "
             f"{launches}, expected {per_step(TRAIN_STEPS)}")
    if not torch.equal(cm_plain, cm_group):
        fail("the group of one's eval matrix differs from the one without "
             "a group")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "device_ms": detail["device_ms"],
            "base_device_ms": base["device_ms"], "collectives": collectives,
            "collective_ms": one_ms}


def rank_processes() -> list:
    """The two ranks of the two-rank CLI run, started on the one card:
    torchrun's environment with LOCAL_RANK 0 for both, and gloo (NCCL
    refuses two ranks on one card)."""
    import os
    from pathlib import Path
    root = str(Path(__file__).resolve().parent)
    port = str(free_port())
    procs = []
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   WORLD_SIZE="2", RANK=str(r), LOCAL_RANK="0",
                   PYTHONPATH=os.pathsep.join(
                       [root] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", DP_RANK_SCRIPT, "--multihost",
             "--dist-backend", "gloo", *DP_CLI_FLAGS], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def rank_results(procs: list) -> list:
    """Each rank's {"losses": [[step, loss]], "launches": {...}}, after it
    exits; fails with a failed rank's output."""
    out = []
    for r, p in enumerate(procs):
        text = p.communicate(timeout=600)[0]
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("RANK_RESULT ")]
        if p.returncode != 0 or len(lines) != 1:
            fail(f"rank {r} of the two-rank CLI run exited "
                 f"{p.returncode}:\n{text[-4000:]}")
        out.append(json.loads(lines[0][len("RANK_RESULT "):]))
        print(f"dp rank {r}: " + " ".join(
            ln for ln in text.splitlines() if ln.startswith("multihost")),
            flush=True)
    return out


def swapped_halves_losses() -> list:
    """The yardstick of the two-rank run's bars: the single-process CLI
    with each global batch's halves swapped, which reorders the same sums.
    Each image keeps its draws: the uint8 batch is swapped before the
    augmentation, and the augmentation's and the dropout's draws are
    swapped with it (`distributed.shard_rows`, the identity without a
    group, swaps the halves of each draw here)."""
    import torch
    from torch_semantic_segmentation_tpu_torch.cli.train import main
    from torch_semantic_segmentation_tpu_torch.data import pipeline
    from torch_semantic_segmentation_tpu_torch.parallel import distributed
    real_prefetch, real_rows = (pipeline.prefetch_to_device,
                                distributed.shard_rows)

    def swap(x, dim=0):
        h = x.shape[dim] // 2
        return torch.cat([x.narrow(dim, h, x.shape[dim] - h),
                          x.narrow(dim, 0, h)], dim=dim)

    def prefetch(*args, **kwargs):
        for batch in real_prefetch(*args, **kwargs):
            yield tuple(swap(t) for t in batch)

    pipeline.prefetch_to_device, distributed.shard_rows = prefetch, swap
    try:
        return [v for _, v in main(DP_CLI_FLAGS).losses]
    finally:
        pipeline.prefetch_to_device, distributed.shard_rows = (
            real_prefetch, real_rows)


def dp_cli_check(ranks: list, single: list) -> dict:
    """The two ranks' losses, the same on both, against the single
    process's within the bars; each rank's K1, K2 and K6 launches."""
    want = [v for _, v in single]
    got = [[v for _, v in r["losses"]] for r in ranks]
    rel = [abs(a - b) / abs(b) for a, b in zip(got[0], want)]
    print(f"dp two ranks on one card (gloo) through the train CLI: losses "
          f"{got[0]} (rank 1 {got[1]}); single process {want}; relative "
          f"gaps {[f'{v:.3g}' for v in rel]} (bars {DP_STEP1_RTOL:g} at "
          f"step 1, {DP_LATER_RTOL:g} after)", flush=True)
    for r, res in enumerate(ranks):
        used = {k: res["launches"][k] for k in
                ("resize_ce_fwd", "resize_ce_bwd", "mbconv_fwd",
                 "mbconv_bwd", "depthwise_fwd", "depthwise_bwd")}
        print(f"dp rank {r} launches: {used}", flush=True)
        want_used = {k: v for k, v in per_step(DP_CLI_STEPS).items()
                     if k in used}
        if used != want_used:
            fail(f"rank {r}'s launches {used}, expected {want_used}")
    if got[0] != got[1] or len(got[0]) != DP_CLI_STEPS:
        fail(f"the ranks' losses differ: {got}")
    if rel[0] > DP_STEP1_RTOL or max(rel[1:]) > DP_LATER_RTOL:
        yard = swapped_halves_losses()
        print(f"dp yardstick, the single process with the halves swapped: "
              f"{yard}, relative gaps "
              f"{[f'{abs(a - b) / abs(b):.3g}' for a, b in zip(yard, want)]}",
              flush=True)
        fail(f"the two-rank losses {got[0]} are off the single process's "
             f"{want} beyond the bars")
    return {"losses": got[0], "single": want, "rel": rel}


def measure_check(main_path: dict) -> float:
    """`profiling.measure` of phase 6's step (8 steps after a warm-up, on
    CUDA events) inside the spread of the same step timed as phase 6 times
    it just before (`timed_steps`: the host's speed drifts over the
    script's minutes), widened by `MEASURE_BAND`; `memory_stats`' peak
    equal to max_memory_allocated. Returns ms a step."""
    import torch
    from torch_semantic_segmentation_tpu_torch import profiling

    model, frames, labels, cfg = phase6_setup()
    step = phase6_step(model, cfg)[0]
    step(frames, labels)                       # warm-up
    lat_ms = timed_steps(step, [(frames, labels)] * TRAIN_STEPS)[0]
    sps, _ = profiling.measure(step, frames, labels, steps=TRAIN_STEPS,
                               warmup=1)
    lo, hi = min(lat_ms), max(lat_ms)
    stats = profiling.memory_stats()
    print(f"tools: measure {1e3 * sps:.3f} ms a step (phase 6's step timed "
          f"as phase 6 times it, just before: {lo:.3f}-{hi:.3f} ms, band "
          f"x{MEASURE_BAND}; phase 6's own run "
          f"{min(main_path['latency_ms']):.3f}-"
          f"{max(main_path['latency_ms']):.3f} ms); memory_stats {stats}",
          flush=True)
    if not MEASURE_BAND[0] * lo <= 1e3 * sps <= MEASURE_BAND[1] * hi:
        fail(f"measure gives {1e3 * sps:.3f} ms, off the step's "
             f"{lo:.3f}-{hi:.3f} ms")
    if stats["peak_bytes_in_use"] != torch.cuda.max_memory_allocated():
        fail(f"memory_stats' peak {stats['peak_bytes_in_use']} against "
             f"max_memory_allocated {torch.cuda.max_memory_allocated()}")
    del model, step
    torch.cuda.empty_cache()
    return 1e3 * sps


def tools_check() -> None:
    """`profiling` and `debug` on phase 6's step: a Chrome trace of one
    step naming K1's, K2's and K6's kernels; `cost_analysis` of one step
    with its kernel launches; `checked_step` on a batch with a NaN pixel
    raises and keeps every parameter, BN statistic, momentum buffer and
    the schedule bit for bit."""
    import tempfile
    import torch
    from torch_semantic_segmentation_tpu_torch import debug, profiling
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        augment_batch)

    model, frames, labels, cfg = phase6_setup()
    step, inner, state, gen = phase6_step(model, cfg)
    step(frames, labels)                 # momentum buffers exist after it
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as path:
            step(frames, labels)
            torch.cuda.synchronize()
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
    found = {k: [any(n in name for name in names) for n in kernels]
             for k, kernels in TRACE_KERNELS.items()}
    print(f"tools: trace of one step, {len(names)} kernel names, "
          f"K1/K2/K6 forward and backward found: {found}", flush=True)
    if not all(all(v) for v in found.values()):
        fail(f"the trace misses kernels: {found}")
    ca = profiling.cost_analysis(step, frames, labels)
    want = {k: v for k, v in per_step(1).items() if v}
    print(f"tools: cost_analysis of one step (ATen operations only): "
          f"{ca['flops'] / 1e12:.3f} TFLOP, {ca['bytes_accessed'] / 1e9:.3f} "
          f"GB, {ca['transcendentals'] / 1e6:.3f} M transcendentals; "
          f"kernel_launches {ca['kernel_launches']}", flush=True)
    if ca["kernel_launches"] != want or ca["flops"] <= 0:
        fail(f"cost_analysis' launches {ca['kernel_launches']}, expected "
             f"{want}")
    images, lab = augment_batch(frames, labels, gen, cfg)
    images[0, 5, 5, 0] = float("nan")
    before = ({k: v.clone() for k, v in model.state_dict().items()},
              [state.optimizer.state[p]["momentum_buffer"].clone()
               for p in model.parameters()],
              state.scheduler.state_dict())
    checked = debug.checked_step(inner)
    try:
        checked(images, lab)
        fail("checked_step did not raise on a NaN pixel")
    except FloatingPointError as e:
        raised = str(e)
    same = (all(torch.equal(v, model.state_dict()[k])
                for k, v in before[0].items())
            and all(torch.equal(m, state.optimizer.state[p]["momentum_buffer"])
                    for m, p in zip(before[1], model.parameters()))
            and before[2] == state.scheduler.state_dict())
    print(f"tools: checked_step on a NaN pixel raised '{raised}'; the state "
          f"{'kept bit for bit' if same else 'CHANGED'}", flush=True)
    if not same:
        fail("checked_step changed the state of a step it refused")
    del model
    torch.cuda.empty_cache()


def dp_phase(main_path: dict) -> dict:
    """Phase 14: the group of one, the profiling and debug tools, and two
    ranks on the one card through the train CLI, whose ranks run beside
    this process's single-process CLI run and tool checks."""
    from torch_semantic_segmentation_tpu_torch.cli.train import main
    t0 = time.perf_counter()
    reset_launch_counts()
    one = group_of_one(main_path)
    measure_ms = measure_check(main_path)
    procs = rank_processes()
    try:
        single = main(DP_CLI_FLAGS).losses
        tools_check()
        ranks = rank_results(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    cli = dp_cli_check(ranks, single)
    print(f"dp phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"group_of_one": one, "cli": cli, "measure_ms": measure_ms}


# phase 15, spatial sharding: FastSCNN at phase 6's configuration on two
# ranks of one data row (num_spatial=2), each on a band of 512 of the 1024
# rows, over gloo on the one card (NCCL refuses two ranks on one card; gloo
# sends no CUDA tensor point to point, so the halos go through host
# memory). Its bars, set before any run: the losses phase 14's (1e-4
# relative at step 1, 1e-3 after); the eval ids equal the single process's
# on at least SP_IDS_SHARE of the pixels (bf16 logits whose top two classes
# tie within a rounding step may flip). Step 1's parameter gradients,
# summed over the ranks, against the single process's by relative L2 over
# the tree: the first bar, 2^-4, failed at 0.3962 on an NVIDIA H100 80GB
# HBM3 at 700 W (the single process's step 1 twice read 0.0086, K2's
# backward atomics alone; PERF.md §6). On the bf16 route a float32 sum in another order (the bands'
# moments) moves bf16 roundings in the forward, which some twenty
# train-mode BNs amplify; the CPU tests hold the same split in float32 at
# 1.8e-5 from the JAX package's float64 gradient. So the bar is now
# SP_GRAD_NOISE times the same amplification measured here: the single
# process's step 1 through the plain versions with K2's folded bias moved
# by one float32 step, against the same step unmoved (the yardstick of
# ContextNet's bar, phase 11). The losses of steps 2-3 follow K2's
# backward atomics too: over 7 calls on an NVIDIA H100 80GB HBM3 at 700 W
# the single process's step 3 read 2.995347-2.998094 and the bands'
# 2.994937-2.996612, a range of 1.05e-3, and one call's pair missed
# phase 14's 1e-3 at 1.05e-3 (PERF.md §6). So the bar of steps 2-3 is now
# SP_LATER_RTOL, twice that range, or SP_GRAD_NOISE times the spread of
# the single process's steps over four runs in the call (as they are,
# twice again, and with every BN's batch mean one float32 step up,
# `nudged_moments`), whichever is larger; step 1's stays 1e-4 (readings
# 1.56e-6).
SP_STEPS = 3
SP_LATER_RTOL = 2e-3
# phase 15's halo exchanges a step on each rank: 17 forward, 16 backward
# (all but the image's); the conv's halo taken in `Conv2d` (PR 22) leaves
# them as they were
SP_HALOS = 33
SP_GRAD_NOISE = 2.0
SP_IDS_SHARE = 0.999
SP_KERNELS = ("resize_ce_fwd", "resize_ce_bwd", "mbconv_fwd", "mbconv_bwd",
              "depthwise_fwd", "depthwise_bwd")
SP_RANK_SCRIPT = "import chip_smoke\nchip_smoke.spatial_rank()\n"
# phase 15's remat step on the two bands, and its step on a crop of 992
# rows: 31 blocks of 32 rows, bands of 512 and 480 (`distributed.split_rows`)
SP_CROP = (992, SERVE_W)
SP_CROP_SPLIT = (512, 480)
# the remat step's halo exchanges on each rank: the step's 33, and the 16
# forward exchanges of the checkpointed segments again in the backward
# (all but the loss's), as counted (`scripts/spatial_halo_plan.py
# --remat`)
SP_REMAT_HALOS = 49


def spatial_steps(model, frames, labels, cfg, sharded: bool,
                  steps: int = SP_STEPS, loss_fn=None, lr: float = 0.045,
                  kernels=SP_KERNELS, remat: bool = False) -> dict:
    """Phase 6's first `steps` steps from the model as it is (a fresh SGD
    state, the augmentation generator from seed 0), each on the rank's
    band of the augmented batch where `sharded` (the split recorded in
    "split"), with `remat` or without: the losses, each step's launches of
    `kernels` and CUDA-event span, step 1's gradient (after the reduction
    over ranks), and the last step's kernel launches recorded. Phase 16
    passes its model's loss, lr and kernels."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        augment_batch)
    from torch_semantic_segmentation_tpu_torch.losses import (
        resize_cross_entropy_loss)
    from torch_semantic_segmentation_tpu_torch.parallel import (
        distributed, shard_batch)
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)
    gen = torch.Generator(device=frames.device).manual_seed(0)
    state = create_train_state(model, OptimizerConfig(lr=lr, max_steps=1000))
    inner = make_train_step(model, state,
                            loss_fn or resize_cross_entropy_loss,
                            device=frames.device, remat=remat)
    grads: dict = {}

    def keep(metrics, m):
        if not grads:
            grads.update({k: p.grad.detach().float().clone()
                          for k, p in m.named_parameters()
                          if p.grad is not None})

    out = {"losses": [], "launches": [], "device_ms": [], "halos": [],
           "halo_bytes": [], "calls": [], "split": None}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        batch = augment_batch(frames, labels, gen, cfg)
        if sharded:
            batch = shard_batch(batch, spatial=True,
                                max_stride=model.max_stride)
            out["split"] = distributed.band_split(batch[0].shape[1])
        reset_launch_counts()
        h0, b0 = distributed.halo_exchanges, distributed.halo_bytes
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with (swapped(recording(out["calls"])) if i == steps - 1
              else contextlib.nullcontext()):
            m = inner(*batch, before_update=keep)
        end.record()
        torch.cuda.synchronize()
        out["losses"].append(float(m["loss"]))
        out["launches"].append({k: v for k, v in launch_counts().items()
                                if k in kernels})
        out["device_ms"].append(start.elapsed_time(end))
        out["halos"].append(distributed.halo_exchanges - h0)
        out["halo_bytes"].append(distributed.halo_bytes - b0)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["grads"] = grads
    return out


def spatial_eval(model, sharded: bool, batch: int = SERVE_BATCH,
                 dtype=None, size: tuple | None = None) -> dict:
    """The eval forward of one batch of `batch` normalised 1024x2048 frames
    (their top-left `size` where given; the rank's band where `sharded`),
    bf16 (or `dtype`): its (main
    head's) logits and ids (FastSCNN's and BiSeNet's 1/8 logits by the
    ×8 resize + argmax, ICNet's 1/4 by ×4, DeepLab's 1/16 by ×16,
    full-resolution logits by the argmax), `evaluate`'s matrix
    over the batch (summed over ranks) and the kernel launches of both
    forwards."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        normalize_batch)
    from torch_semantic_segmentation_tpu_torch.eval import evaluate
    from torch_semantic_segmentation_tpu_torch.ops.upsample import (
        resize_argmax)
    from torch_semantic_segmentation_tpu_torch.parallel import (
        distributed, shard_batch)
    from torch_semantic_segmentation_tpu_torch.train import make_eval_step
    dev = next(model.parameters()).device
    f, lab = make_batch(301)
    h, w = size or f.shape[1:3]
    pair = (normalize_batch(torch.from_numpy(f[:batch, :h, :w]).to(dev),
                            out_dtype=dtype or torch.bfloat16),
            torch.from_numpy(lab[:batch, :h, :w]).to(dev))
    split = None
    if sharded:
        pair = shard_batch(pair, spatial=True, max_stride=model.max_stride)
        split = distributed.band_split(pair[0].shape[1])
    images, labels = pair
    model.eval()
    reset_launch_counts()
    with torch.inference_mode():
        logits = model(images)
        if isinstance(logits, tuple):     # the main head of aux heads
            logits = logits[0]
        ids = resize_argmax(logits, tuple(labels.shape[1:]),
                            out_dtype=torch.int32)
    cm = evaluate(make_eval_step(model, num_classes=NUM_CLASSES, device=dev),
                  [(images, labels)], num_classes=NUM_CLASSES, device=dev)[2]
    return {"logits": logits.float(), "ids": ids, "cm": cm,
            "eval_split": split,
            "eval_launches": {k: v for k, v in launch_counts().items() if v}}


def spatial_more(model, frames, labels, cfg, start: dict,
                 sharded: bool) -> dict:
    """Phase 15's remat step ("remat") and its step on the SP_CROP crop
    ("crop"), each one step from `start` (phase 6's model from seed 0)
    with the dropout generator at seed 0, on the rank's band where
    `sharded`: `spatial_steps`' record of each, and on a band each
    kernel launch held against its plain version on its own inputs
    (`check_recorded`). In one process also the crop's yardsticks: its
    step again, with every BN's batch mean, and with its mean and mean
    square, one float32 step up ("crop_again", "crop_moments",
    "crop_squares", the loss's, as phase 15's and 16's), and through the
    plain versions with and without K2's folded bias one float32 step up
    ("crop_plain", "crop_nudged", the gradient's)."""
    import dataclasses
    out = {}
    crop = dataclasses.replace(cfg, crop=SP_CROP)
    plans = [("remat", cfg, True, contextlib.nullcontext),
             ("crop", crop, False, contextlib.nullcontext)]
    if not sharded:
        plans += [("crop_again", crop, False, contextlib.nullcontext),
                  ("crop_moments", crop, False, nudged_moments),
                  ("crop_squares", crop, False,
                   functools.partial(nudged_moments, squares=True)),
                  ("crop_plain", crop, False,
                   functools.partial(swapped, plain_versions)),
                  ("crop_nudged", crop, False,
                   functools.partial(swapped, nudged_plain_versions))]
    for key, c, remat, ctx in plans:
        model.load_state_dict(start)
        model.dropout_generator.manual_seed(0)
        with ctx():
            res = spatial_steps(model, frames, labels, c, sharded, steps=1,
                                remat=remat)
        calls = res.pop("calls")
        if sharded:
            res["recorded"] = check_recorded(calls)
        del calls
        res["grads"] = {k: v.cpu() for k, v in res["grads"].items()}
        out[key] = res
    return out


def spatial_rank() -> None:
    """One rank of phase 15, in a process of its own (`spatial_phase`
    starts two, with torchrun's environment and SP_OUT): phase 6's model
    and steps on the rank's band, each K1, K2 and K6 launch of the last
    step held against its plain version on its own inputs
    (`check_recorded`), then the eval forward, the remat step and the
    step on the 992-row crop (`spatial_more`); writes its results to
    SP_OUT/rank<r>.pt."""
    import os
    import torch
    from torch_semantic_segmentation_tpu_torch.parallel import distributed
    distributed.initialize(backend="gloo", num_spatial=2)
    model, frames, labels, cfg = phase6_setup()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    res = spatial_steps(model, frames, labels, cfg, sharded=True)
    res["recorded"] = check_recorded(res.pop("calls"))
    res.update(spatial_eval(model, sharded=True))
    res["more"] = spatial_more(model, frames, labels, cfg, start,
                               sharded=True)
    res["grads"] = {k: v.cpu() for k, v in res["grads"].items()}
    for k in ("logits", "ids", "cm"):
        res[k] = res[k].cpu()
    torch.save(res, os.path.join(os.environ["SP_OUT"],
                                 f"rank{distributed.rank()}.pt"))
    distributed.barrier()
    distributed.destroy()


def spatial_processes(out: str, script: str = SP_RANK_SCRIPT) -> list:
    """The two ranks of phase 15 (or 16: `script`), started on the one
    card: torchrun's environment with LOCAL_RANK 0 for both."""
    import os
    from pathlib import Path
    root = str(Path(__file__).resolve().parent)
    port = str(free_port())
    procs = []
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   WORLD_SIZE="2", RANK=str(r), LOCAL_RANK="0", SP_OUT=out,
                   PYTHONPATH=os.pathsep.join(
                       [root] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def rel_tree(got: dict, want: dict, keys=None) -> float:
    keys = list(want) if keys is None else keys
    d = sum(float(((got[k].double().cpu() - want[k].double().cpu()) ** 2)
                  .sum()) for k in keys)
    m = sum(float((want[k].double().cpu() ** 2).sum()) for k in keys)
    return (d / m) ** 0.5


def tree_gaps(got: dict, want: dict) -> str:
    """The classifier's gap (FastSCNN's, DeepLab's and ContextNet's
    `classifier.`, UNet's `head.`, ENet's `fullconv.`, ERFNet's and
    ESNet's `output_conv.`, LEDNet's APN projections) and the three
    tensors that add most to the tree's, each with its own relative
    gap."""
    head = [k for k in want if k.startswith(
        ("classifier.", "head.", "fullconv.", "output_conv.", "apn.main.",
         "apn.pool_proj."))]
    top = sorted(want, key=lambda k: -float(
        (got[k].double().cpu() - want[k].double().cpu()).norm()))[:3]
    return (f"classifier {rel_tree(got, want, head):.4g}; most: " + ", ".join(
        f"{k} {rel_tree(got, want, [k]):.3g}" for k in top))


def spatial_phase(main_path: dict) -> dict:
    """Phase 15: `check_spatial_extent` on a degenerate split; the single
    process's reference (phase 6's first steps, the eval forward), timed,
    and its yardsticks (the steps twice again and once with
    `nudged_moments`, step 1 through the plain versions with and without
    K2's folded bias nudged); its remat step and its step on a 992-row
    crop (`spatial_more`); then the two ranks, held against it
    (`spatial_more_check` for the remat and the crop)."""
    import tempfile
    import torch
    from torch_semantic_segmentation_tpu_torch.parallel import (
        check_spatial_extent)
    t0 = time.perf_counter()
    try:
        check_spatial_extent(32, 2)
        fail("check_spatial_extent(32, 2) did not raise")
    except ValueError as e:
        guard = str(e)
    if not guard.startswith("degenerate spatial sharding"):
        fail(f"check_spatial_extent(32, 2) raised '{guard}'")
    model, frames, labels, cfg = phase6_setup()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    single = spatial_steps(model, frames, labels, cfg, sharded=False)
    single.pop("calls")
    single.update(spatial_eval(model, sharded=False))
    runs, again_losses = {}, {}
    for name, ctx, steps in (
            ("again", contextlib.nullcontext(), SP_STEPS),
            ("again2", contextlib.nullcontext(), SP_STEPS),
            ("moments", nudged_moments(), SP_STEPS),
            ("plain", swapped(plain_versions), 1),
            ("nudged", swapped(nudged_plain_versions), 1)):
        model.load_state_dict(start)
        model.dropout_generator.manual_seed(0)    # phase6_setup's seed
        with ctx:
            res = spatial_steps(model, frames, labels, cfg, sharded=False,
                                steps=steps)
        runs[name] = res["grads"]
        again_losses[name] = res["losses"]
    more = spatial_more(model, frames, labels, cfg, start, sharded=False)
    noise = rel_tree(runs["again"], single["grads"])
    yard = rel_tree(runs["nudged"], runs["plain"])
    yard_gaps = tree_gaps(runs["nudged"], runs["plain"])
    # each step's loss yardstick: the spread of the single process's steps,
    # run again twice (K2's backward sums with atomics) and once with every
    # BN's batch mean one float32 step up
    loss_yard = [(max(v) - min(v)) / abs(v[0]) for v in zip(
        single["losses"], again_losses["again"], again_losses["again2"],
        again_losses["moments"])]
    del model, runs, start
    torch.cuda.empty_cache()
    t_ranks = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        procs = spatial_processes(out, SP_RANK_SCRIPT)
        try:
            for r, p in enumerate(procs):
                text = p.communicate(timeout=600)[0]
                if p.returncode != 0:
                    fail(f"rank {r} of phase 15 exited {p.returncode}:\n"
                         f"{text[-4000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        ranks = [torch.load(f"{out}/rank{r}.pt", weights_only=False)
                 for r in range(2)]
    ranks_s = time.perf_counter() - t_ranks

    want = single["losses"]
    got = ranks[0]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    # 1e-4 at step 1 and SP_LATER_RTOL after, or SP_GRAD_NOISE times the
    # loss yardstick where that is larger (set after a failure at step 3)
    loss_bars = [max(DP_STEP1_RTOL if i == 0 else SP_LATER_RTOL,
                     SP_GRAD_NOISE * v) for i, v in enumerate(loss_yard)]
    gap = rel_tree(ranks[0]["grads"], single["grads"])
    ids = torch.cat([r["ids"] for r in ranks], dim=1)
    logits = torch.cat([r["logits"] for r in ranks], dim=1)
    share = float((ids == single["ids"].cpu()).float().mean())
    lgap = float((logits - single["logits"].cpu()).abs().max())
    lscale = float(single["logits"].abs().max())
    moved = int((ranks[0]["cm"] - single["cm"].cpu()).abs().sum()) // 2
    print(f"spatial phase: check_spatial_extent(32, 2) raised '{guard}'",
          flush=True)
    print(f"spatial two ranks on one card (gloo, num_spatial=2, bands of "
          f"{SERVE_H // 2} rows of {SERVE_BATCH}x{SERVE_H}x{SERVE_W}): "
          f"losses {got} (rank 1 {ranks[1]['losses']}); single process "
          f"{want}; relative gaps {[f'{v:.3g}' for v in rel]} (bars "
          f"{[f'{v:.3g}' for v in loss_bars]}: {DP_STEP1_RTOL:g} at step 1 "
          f"and {SP_LATER_RTOL:g} after, or {SP_GRAD_NOISE:g} x the spread "
          f"of the single process's steps, again twice and with every BN's "
          f"batch mean one float32 step up, "
          f"{[f'{v:.3g}' for v in loss_yard]})", flush=True)
    print(f"spatial step 1's gradient against the single process's: "
          f"relative L2 over the tree {gap:.4g} ("
          f"{tree_gaps(ranks[0]['grads'], single['grads'])}); bar "
          f"{SP_GRAD_NOISE:g} x {yard:.4g}, the plain versions' step 1 with "
          f"K2's folded bias one float32 step up against it unmoved ("
          f"{yard_gaps}); the single process's step 1 twice: {noise:.4g}",
          flush=True)
    for r, res in enumerate(ranks):
        print(f"spatial rank {r}: launches a step {res['launches']}; halo "
              f"exchanges a step {res['halos']}, bytes sent "
              f"{res['halo_bytes']}; step CUDA events "
              f"{[round(t, 3) for t in res['device_ms']]} ms (median "
              f"{np.median(res['device_ms']):.3f}); max_memory_allocated "
              f"{res['peak_bytes'] / 2 ** 30:.3f} GiB; kernel vs plain on "
              f"the last step's own inputs, worst relative L2 "
              f"{ {k: float(f'{v:.3g}') for k, v in res['recorded'].items()} }",
              flush=True)
    print(f"spatial single process just before: step CUDA events "
          f"{[round(t, 3) for t in single['device_ms']]} ms (median "
          f"{np.median(single['device_ms']):.3f}; phase 6's own median "
          f"{np.median(main_path['device_ms']):.3f}); max_memory_allocated "
          f"{single['peak_bytes'] / 2 ** 30:.3f} GiB", flush=True)
    print(f"spatial eval forward: ids equal on {share:.6f} of the pixels "
          f"(bar {SP_IDS_SHARE}); 1/8 logits max |diff| {lgap:.4g} (scale "
          f"{lscale:.4g}); evaluate's matrix: {moved} pixels moved of "
          f"{int(single['cm'].sum())}; ranks {ranks_s:.1f} s, phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    want_launches = {k: v for k, v in per_step(1).items() if k in SP_KERNELS}
    for r, res in enumerate(ranks):
        if any(h != SP_HALOS for h in res["halos"]):
            fail(f"spatial rank {r}'s halo exchanges {res['halos']}, "
                 f"expected {SP_HALOS} a step")
        if any(steps != want_launches for steps in res["launches"]):
            fail(f"spatial rank {r}'s launches {res['launches']}, expected "
                 f"{want_launches} a step")
        if res["losses"] != got:
            fail(f"the spatial ranks' losses differ: {[x['losses'] for x in ranks]}")
    if not all(np.isfinite(got)) or any(
            v > b for v, b in zip(rel, loss_bars)):
        fail(f"the spatial losses {got} are off the single process's {want} "
             f"(bars {loss_bars})")
    if not gap <= SP_GRAD_NOISE * yard:
        fail(f"the spatial step's gradient is {gap:.4g} off the single "
             f"process's (bar {SP_GRAD_NOISE:g} x {yard:.4g})")
    if not share >= SP_IDS_SHARE or int(ranks[0]["cm"].sum()) != int(
            single["cm"].sum()):
        fail(f"the spatial eval ids equal the single process's on {share} "
             f"of the pixels; matrices of {int(ranks[0]['cm'].sum())} and "
             f"{int(single['cm'].sum())} pixels")
    checked = spatial_more_check(ranks, more, loss_bars[0], want_launches)
    return {"ranks": ranks, "single": single, "rel": rel, "grad_gap": gap,
            "noise": noise, "yard": yard, "ids_share": share,
            "loss_bars": loss_bars, "more": checked}


def spatial_more_check(ranks: list, single: dict, loss_bar: float,
                       want_launches: dict) -> dict:
    """The ranks' remat step and 992-row crop step (`spatial_more`)
    against the single process's: the remat step's loss within phase 15's
    step-1 bar (`loss_bar`), the crop's within phase 15's step-1 bar at
    the crop (DP_STEP1_RTOL or SP_GRAD_NOISE times the spread of the
    single process's crop step, again, with every BN's batch mean and
    with its mean and mean square one float32 step up, as phase 16's
    yardstick: the unequal bands weigh their moments by 512/992 and
    480/992, which round, where equal bands weigh by 1/2), the crop's
    gradient within SP_GRAD_NOISE times its own yardstick (phase 15's, at
    the crop); the remat step's launches those of the single process's
    remat step (K1 1 + 1, K6's forward again in the recompute, no K2) and
    SP_REMAT_HALOS exchanges; the crop's phase 6's launches, SP_HALOS
    exchanges, on bands of SP_CROP_SPLIT rows. Prints each band's peak
    memory with remat beside phase 15's steps without it."""
    out = {}
    yard = rel_tree(single["crop_nudged"]["grads"],
                    single["crop_plain"]["grads"])
    crop_losses = [single[k]["losses"][0] for k in (
        "crop", "crop_again", "crop_moments", "crop_squares")]
    crop_spread = (max(crop_losses) - min(crop_losses)) / abs(crop_losses[0])
    bars = {"remat": loss_bar,
            "crop": max(DP_STEP1_RTOL, SP_GRAD_NOISE * crop_spread)}
    for key in ("remat", "crop"):
        want = single[key]
        loss_bar = bars[key]
        rel = abs(ranks[0]["more"][key]["losses"][0] - want["losses"][0]) / (
            abs(want["losses"][0]))
        gap = rel_tree(ranks[0]["more"][key]["grads"], want["grads"])
        out[key] = {"rel": rel, "grad_gap": gap}
        what = ("remat step" if key == "remat" else
                f"step on a {SP_CROP[0]}x{SP_CROP[1]} crop (bands of "
                f"{ranks[0]['more'][key]['split']})")
        print(f"spatial {what}: loss {ranks[0]['more'][key]['losses']} "
              f"(rank 1 {ranks[1]['more'][key]['losses']}); single process "
              f"{want['losses']}; relative gap {rel:.3g} (bar "
              f"{loss_bar:.3g}"
              + ("" if key == "remat" else
                 f": {DP_STEP1_RTOL:g} or {SP_GRAD_NOISE:g} x the spread "
                 f"{crop_spread:.3g} of {crop_losses}, the single process's "
                 f"crop step, again, and with every BN's batch mean, and "
                 f"its mean and mean square, one float32 step up")
              + f"); gradient against the single process's, "
              f"relative L2 over the tree {gap:.4g} ("
              f"{tree_gaps(ranks[0]['more'][key]['grads'], want['grads'])}"
              + ("; not held: K2 is off in the remat step" if key == "remat"
                 else f"; bar {SP_GRAD_NOISE:g} x {yard:.4g}, the plain "
                 f"versions' crop step with K2's folded bias one float32 "
                 f"step up against it unmoved") + ")", flush=True)
        for r, res in enumerate(ranks):
            m = res["more"][key]
            print(f"spatial {what} rank {r}: launches {m['launches'][0]}; "
                  f"halo exchanges {m['halos'][0]}, bytes sent "
                  f"{m['halo_bytes'][0]}; step CUDA events "
                  f"{m['device_ms'][0]:.3f} ms; max_memory_allocated "
                  f"{m['peak_bytes'] / 2 ** 30:.3f} GiB (phase 15's steps "
                  f"without remat {res['peak_bytes'] / 2 ** 30:.3f} GiB); "
                  f"kernel vs plain on its own inputs, worst relative L2 "
                  f"{ {k: float(f'{v:.3g}') for k, v in m['recorded'].items()} }",
                  flush=True)
        print(f"spatial {what}, single process: step CUDA events "
              f"{want['device_ms'][0]:.3f} ms; launches {want['launches'][0]};"
              f" max_memory_allocated {want['peak_bytes'] / 2 ** 30:.3f} GiB",
              flush=True)
        if not np.isfinite(rel) or rel > loss_bar:
            fail(f"the spatial {what}'s loss is {rel:.3g} off the single "
                 f"process's (bar {loss_bar:.3g})")
        if key == "crop" and not gap <= SP_GRAD_NOISE * yard:
            fail(f"the spatial {what}'s gradient is {gap:.4g} off the single "
                 f"process's (bar {SP_GRAD_NOISE:g} x {yard:.4g})")
        launches = want["launches"][0] if key == "remat" else want_launches
        halos = SP_REMAT_HALOS if key == "remat" else SP_HALOS
        for r, res in enumerate(ranks):
            m = res["more"][key]
            if m["launches"][0] != launches or m["halos"][0] != halos:
                fail(f"spatial {what} rank {r}: launches {m['launches'][0]} "
                     f"and {m['halos'][0]} halo exchanges, expected "
                     f"{launches} and {halos}")
        if key == "remat" and (launches["mbconv_fwd"] or launches[
                "resize_ce_fwd"] != 1 or launches["resize_ce_bwd"] != 1
                or launches["depthwise_fwd"] <= launches["depthwise_bwd"]):
            fail(f"the remat step launched {launches}: K1 1 + 1, no K2, K6's "
                 "forward again in the recompute expected")
        if key == "crop" and tuple(ranks[0]["more"][key]["split"]) != (
                SP_CROP_SPLIT):
            fail(f"the {SP_CROP[0]}-row crop split into "
                 f"{ranks[0]['more'][key]['split']}, not {SP_CROP_SPLIT}")
    return out


# phase 16, spatial sharding of the zoo on two gloo ranks of one data row,
# bf16 compute and float32 parameters at full width and depth, held
# against one process at phase 15's bars: DeepLabV3-ResNet50 (BASELINE
# config 4's loss and lr, crop 768x768) and UNet's bilinear decoder (base
# 64, crop 768x768), bands of 384 rows; ENet at BASELINE config 1 (512x512
# crops, scale 0.5-2.0, lr 0.05, CE with `cityscapes.enet_class_weights`),
# bands of 256 rows; ERFNet and ESNet at the zoo benches' 768x768 and lr
# 0.045, bands of 384 rows; BiSeNet-R18 and ICNet-R50 at BASELINE config
# 5 (1024x1024 crops, scale 0.75-2.0, lr 0.025, OHEM 0.7 / 100000 on
# each of the three heads at its own ratio through K3, aux weight 1.0),
# bands of 512 rows; LEDNet and ContextNet at the zoo benches' 768x768
# and lr 0.045 on their fused route (1/8 logits, the x8 resize inside the
# loss through K1; ContextNet's twelve blocks through K2 and its ds1
# through K6), bands of 384 rows. The batch is 4 for all, config 1's own
# for ENet and cut from config 4's and config 5's 16, the UNet phase's 8
# and the zoo benches' 8 (ContextNet's 32): every halo and collective goes
# through host memory under gloo. ENet also runs at CamVid's 360x480 on
# bands of 184 and 176 rows ("enet_camvid"), and BiSeNet's multi-scale
# step on two BDD100K frames of 720x1280 (`ZS_BDD`). The yardstick is the single process's run with every train-mode
# BN's batch mean moved up one float32 step (`nudged_moments`): these
# models run no K2, whose folded bias phase 15 nudges. Each loss's bar is
# phase 15's or twice the nudge's gap at that step, whichever is larger:
# DeepLab's first reading missed 1e-4 at step 1 (2.43e-4), where the
# nudge alone moves the loss 5.16e-4 (PERF.md §6). ICNet's first reading
# missed that bar (2.14e-4 against 2 x 8.74e-5), where a nudge of every
# BN's mean square too moves its loss 1.97e-4: the bands sum both moments
# in another order, and the variance's cancellation amplifies the
# squares' step. So the yardstick is the larger of two nudges, the means
# alone and the means and mean squares, at every step and for the
# gradient; ContextNet runs K2, so its yardstick is the largest of those
# two and phase 15's nudge of K2's folded bias. ZS_HALOS is each model's
# halo exchanges a step on each rank (forward, and backward for all but
# the image's halo): DeepLab's and UNet's as measured on the card, the
# others' as counted (`scripts/spatial_halo_plan.py`). BiSeNet and ICNet
# also run config 5's multi-scale + flip eval step on the bands
# (ZS_MULTISCALE), held against one process's step on the same frames.
ZS_BATCH = 4
# "enet_camvid" is ENet at CamVid's 360x480 (the ENet paper's CamVid
# setting, BASELINE config 3's frame size), batch 4, on bands of 184 and
# 176 rows: 45 blocks of 8 rows dealt 23/22 (`distributed.split_rows`)
ZS_STEPS = {"deeplab": 3, "unet": 1, "enet": 2, "erfnet": 1, "esnet": 1,
            "bisenet": 1, "icnet": 1, "lednet": 1, "contextnet": 1,
            "enet_camvid": 1}
ZS_CROP = {"deeplab": DEEPLAB_CROP, "unet": UNET_CROP, "enet": ENET_CROP,
           "erfnet": ZOO_CROP, "esnet": ZOO_CROP, "bisenet": CONFIG5_CROP,
           "icnet": CONFIG5_CROP, "lednet": ZOO_CROP, "contextnet": ZOO_CROP,
           "enet_camvid": (360, 480)}
# the batch each model's configuration trains at
ZS_CONFIG_BATCH = {"deeplab": DEEPLAB_BATCH, "unet": UNET_BATCH,
                   "enet": ENET_BATCH, "bisenet": CONFIG5_BATCH,
                   "icnet": CONFIG5_BATCH, "enet_camvid": ZS_BATCH,
                   **STRETCH_BATCH}
ZS_HALOS = {"deeplab": 43, "unet": 43, "enet": 57, "erfnet": 77,
            "esnet": 69, "bisenet": 64, "icnet": 56, "lednet": 123,
            "contextnet": 44, "enet_camvid": 57}


def zs_crop(name: str) -> tuple[int, int]:
    """Phase 16's crop of `name`, (H, W)."""
    crop = ZS_CROP[name]
    return tuple(crop) if isinstance(crop, tuple) else (crop, crop)
# K6 routes a depthwise conv of at least DEPTHWISE_MIN_PX (2^18) input
# pixels of the global image: at batch 4 ContextNet's ds1 (4x384x384) in
# a step, and ds1 and ds2 (4x512x1024, 4x256x512) in the eval of 4
# 1024x2048 frames; ds2 in a step (4x192x192) and context body[2] in the
# eval (4x128x256) lie under it, where phase 11's batches of 32 and 8
# route them. So ContextNet's K6 launches a step and an eval forward, in
# place of `per_step`'s 2 and phase 11's 3 (`spatial_eval` runs two
# forwards)
ZS_K6 = {"contextnet": (1, 2)}
ZS_MULTISCALE = ("bisenet", "icnet")
# the halo exchanges of one multi-scale + flip call on each of the two
# bands, as counted (`scripts/spatial_halo_plan.py --multiscale`) and read
# on the card: the matrices' pixel bar is far too wide to see a resize
# that drops or misplaces a halo row, so the count holds the route
ZS_MS_HALOS = {"bisenet": 376, "icnet": 328}
# BiSeNet's multi-scale + flip call on two BDD100K frames of 720x1280
# (`zoo_multiscale(size=ZS_BDD)`): equal bands of 360 rows (720 is no
# multiple of 32), the scales' images of 352, 544, 704, 896, 1088 and
# 1248 rows on bands of 192/160, 288/256, 352/352, 448/448, 544/544 and
# 640/608; its halo exchanges on each band, as counted
# (`scripts/spatial_halo_plan.py --multiscale --rows 720`)
ZS_BDD = (720, 1280)
# the frames of each model's eval forward where they are not 1024x2048
ZS_EVAL_SIZE = {"enet_camvid": (360, 480)}
ZS_MS_BDD_HALOS = 378
ZS_RANK_SCRIPT = "import chip_smoke\nchip_smoke.zoo_spatial_rank()\n"


def zoo_spatial_model(name: str, device: str = "cuda", compute_dtype=None):
    """(model, loss, augmentation, lr, frame seed) of phase 16's `name`:
    DeepLabV3-ResNet50 with `upsample_logits=False` and OHEM (thresh 0.7,
    min_kept 100000; scale 0.5-2.0, lr 0.01, phase 8's frames); UNet's
    bilinear decoder with CE (lr 0.045, phase 7's frames); ENet with
    config 1's class-weighted CE (scale 0.5-2.0, lr 0.05, the ENet
    phase's frames; "enet_camvid" the same at crop 360x480); ERFNet or ESNet with CE (lr 0.045, phase 11's
    frames); BiSeNet-R18 or ICNet-R50 with config 5's loss (scale
    0.75-2.0, lr 0.025, phase 9's frames); LEDNet or ContextNet with
    `upsample_logits=False` and the resize CE (K1; lr 0.045, phase 11's
    frames); float32 parameters from seed 0, bf16 compute (or
    `compute_dtype`)."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.cityscapes import (
        enet_class_weights)
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        AugmentConfig)
    from torch_semantic_segmentation_tpu_torch.losses import (
        cross_entropy_loss, resize_cross_entropy_loss,
        resize_ohem_cross_entropy)
    from torch_semantic_segmentation_tpu_torch.models import get_model
    kw = dict(compute_dtype=compute_dtype or torch.bfloat16, seed=0,
              device=device)
    crop = zs_crop(name)
    if name == "deeplab":
        model = get_model("deeplabv3_resnet50", NUM_CLASSES,
                          upsample_logits=False, **kw)
        cfg = AugmentConfig(crop=crop, scale_range=(0.5, 2.0),
                            out_dtype=torch.bfloat16)
        loss = functools.partial(resize_ohem_cross_entropy,
                                 thresh=OHEM_THRESH, min_kept=OHEM_MIN_KEPT)
        return model, loss, cfg, DEEPLAB_LR, 600
    if name == "unet":
        model = get_model("unet", NUM_CLASSES, base_ch=64, upsample="bilinear",
                          **kw)
        cfg = AugmentConfig(crop=crop, out_dtype=torch.bfloat16)
        return model, cross_entropy_loss, cfg, UNET_LR, 500
    if name in dict(CONFIG5_MODELS):
        model = get_model(name, NUM_CLASSES,
                          depth=dict(CONFIG5_MODELS)[name],
                          upsample_logits=False, **kw)
        cfg = AugmentConfig(crop=crop, scale_range=CONFIG5_SCALE,
                            out_dtype=torch.bfloat16)
        return model, config5_loss(), cfg, CONFIG5_LR, 700
    if name in STRETCH_LOW_RES:
        model = get_model(name, NUM_CLASSES, upsample_logits=False, **kw)
        cfg = AugmentConfig(crop=crop, out_dtype=torch.bfloat16)
        return model, resize_cross_entropy_loss, cfg, ZOO_LR, 1100
    model = get_model(name.split("_")[0], NUM_CLASSES, **kw)
    if name.startswith("enet"):
        cfg = AugmentConfig(crop=crop, scale_range=ENET_SCALE,
                            out_dtype=torch.bfloat16)
        loss = functools.partial(
            cross_entropy_loss, class_weights=torch.from_numpy(
                enet_class_weights()).to(device))
        return model, loss, cfg, ENET_LR, 800
    cfg = AugmentConfig(crop=crop, out_dtype=torch.bfloat16)
    return model, cross_entropy_loss, cfg, ZOO_LR, 1100


def zoo_spatial_setup(name: str):
    """(model, frames, labels, augmentation, loss, lr) of phase 16's
    `name` (`zoo_spatial_model`), with ZS_BATCH frames of its seed's
    `make_batch` on the card."""
    import torch
    model, loss, cfg, lr, seed = zoo_spatial_model(name)
    frames, labels = make_batch(seed)
    return (model, torch.from_numpy(frames[:ZS_BATCH]).cuda(),
            torch.from_numpy(labels[:ZS_BATCH]).cuda(), cfg, loss, lr)


def zoo_spatial_run(name: str, sharded: bool, steps: int | None = None):
    """Phase 16's `name` from seed 0: `steps` training steps (its ZS_STEPS
    by default), with the launches of every kernel a step, on the rank's
    band where `sharded`; returns (the model, the steps' record)."""
    import torch
    model, frames, labels, cfg, loss, lr = zoo_spatial_setup(name)
    keys = tuple(k for k, _, _, _ in TRAIN_WRAPPERS)
    res = spatial_steps(model, frames, labels, cfg, sharded,
                        steps=steps or ZS_STEPS[name], loss_fn=loss, lr=lr,
                        kernels=keys)
    torch.cuda.synchronize()
    return model, res


@contextlib.contextmanager
def nudged_moments(squares: bool = False):
    """Within the block every train-mode BN's batch mean is one float32
    step up (its gradient unchanged): the BNs' bf16 outputs then round
    differently wherever the float32 value lies within that step of a
    rounding boundary, as a sum of the bands' parts in another order
    makes them (a yardstick of this script only). With `squares`, so is
    every batch mean square, which the bands sum from their parts too:
    its step moves the variance E[x²] − E[x]² by up to (E[x]/σ)² float32
    steps of it, where the mean's step moves the output by E[x]/σ."""
    import torch
    from torch_semantic_segmentation_tpu_torch.ops import conv
    real = conv.batch_moments

    def up(y):
        m = y.detach()
        return y + (torch.nextafter(m, torch.full_like(m, np.inf)) - m)

    def nudged(x, dims):
        mean, sq = real(x, dims)
        return up(mean), (up(sq) if squares else sq)

    conv.batch_moments = nudged
    try:
        yield
    finally:
        conv.batch_moments = real


def zoo_multiscale(model, sharded: bool, size: tuple | None = None) -> dict:
    """Config 5's multi-scale + flip eval step (scales 0.5 .. 1.75) over
    one batch of MULTISCALE_BATCH normalised 1024x2048 frames of
    `make_batch(301)` (`spatial_eval`'s; their top-left `size` where
    given), bf16, on the rank's band where `sharded`, through `evaluate`
    (the matrix summed over ranks): the matrix, mIoU, host and CUDA-event
    ms of the one call, its halo exchanges and kernel launches."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        normalize_batch)
    from torch_semantic_segmentation_tpu_torch.eval import (
        evaluate, make_multiscale_eval_step)
    from torch_semantic_segmentation_tpu_torch.parallel import (
        distributed, shard_batch)
    dev = next(model.parameters()).device
    f, lab = make_batch(301)
    h, w = size or f.shape[1:3]
    pair = (normalize_batch(torch.from_numpy(
        f[:MULTISCALE_BATCH, :h, :w]).to(dev), out_dtype=torch.bfloat16),
            torch.from_numpy(lab[:MULTISCALE_BATCH, :h, :w]).to(dev))
    if sharded:
        pair = shard_batch(pair, spatial=True, max_stride=model.max_stride)
    step = make_multiscale_eval_step(model, num_classes=NUM_CLASSES,
                                     device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    h0 = distributed.halo_exchanges
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    _, miou, cm = evaluate(step, [pair], num_classes=NUM_CLASSES, device=dev)
    end.record()
    torch.cuda.synchronize()
    return {"cm": cm.cpu(), "miou": float(miou),
            "ms": 1e3 * (time.perf_counter() - t0),
            "event_ms": start.elapsed_time(end),
            "halos": distributed.halo_exchanges - h0,
            "launches": {k: v for k, v in launch_counts().items() if v},
            "valid": int((pair[1] != 255).sum()),
            "size": (h, w)}


def k4_band_check(calls: list) -> list:
    """Each K4 launch of a band's step again, against the unsharded K4 on
    the data row's whole input, put together from every band's rows of
    `low` (its halo rows dropped) and `skip` by a CPU all-gather over the
    gloo group: the band's output equals the whole output's rows of this
    band bit for bit. Returns each launch's max |diff|."""
    import torch
    import torch.distributed as dist
    from torch_semantic_segmentation_tpu_torch.parallel import distributed
    s, n = distributed.spatial_rank(), distributed.num_spatial()
    out = []
    for key, fn, _, (low, skip, row0) in calls:
        if key != "upsample_concat":
            continue
        rows = skip.shape[1] // 2
        band = low[:, row0 // 2:row0 // 2 + rows]
        whole = []
        for t in (band, skip):
            parts = [torch.empty_like(t, device="cpu") for _ in range(n)]
            dist.all_gather(parts, t.cpu().contiguous())
            whole.append(torch.cat(parts, dim=1).to(t.device))
        with torch.no_grad():
            got = fn(low, skip, row0)
            want = fn(*whole).narrow(1, 2 * s * rows, 2 * rows)
        torch.cuda.synchronize()
        out.append(float((got.float() - want.float()).abs().max()))
        if not torch.equal(got, want):
            fail(f"K4 on band {s} (low {tuple(low.shape)} from output row "
                 f"{row0}) differs from the unsharded K4's rows: max |diff| "
                 f"{out[-1]}")
    return out


def zoo_spatial_rank() -> None:
    """One rank of phase 16, in a process of its own (`zoo_spatial_phase`
    starts two, with torchrun's environment and SP_OUT): each model's
    steps on the rank's band, each launch of the last step held
    against its plain version on its own inputs (`check_recorded`), UNet's
    K4 launches against the unsharded K4 (`k4_band_check`), then the eval
    forward of each on the weights the single process's steps reached
    (SP_OUT/zoo_<name>.pt: a step's noise, which the image-level BN's
    E[x²]−E[x]² over 4 values amplifies, stays out of the eval's check),
    and for BiSeNet and ICNet the multi-scale step (`zoo_multiscale`);
    writes its results to SP_OUT/zoo_rank<r>.pt."""
    import os
    import torch
    from torch_semantic_segmentation_tpu_torch.parallel import distributed
    distributed.initialize(backend="gloo", num_spatial=2)
    out = {}
    for name in ZS_STEPS:
        model, res = zoo_spatial_run(name, sharded=True)
        calls = res.pop("calls")
        res["recorded"] = check_recorded(calls)
        if name == "unet":
            res["k4_band"] = k4_band_check(calls)
        del calls
        model.load_state_dict(torch.load(
            os.path.join(os.environ["SP_OUT"], f"zoo_{name}.pt")))
        res.update(spatial_eval(model, sharded=True, batch=ZS_BATCH,
                                size=ZS_EVAL_SIZE.get(name)))
        if name in ZS_MULTISCALE:
            res["multiscale"] = zoo_multiscale(model, sharded=True)
        if name == "bisenet":
            res["multiscale_bdd"] = zoo_multiscale(model, sharded=True,
                                                   size=ZS_BDD)
        res["grads"] = {k: v.cpu() for k, v in res["grads"].items()}
        for k in ("logits", "ids", "cm"):
            res[k] = res[k].cpu()
        out[name] = res
        del model
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(os.environ["SP_OUT"],
                                 f"zoo_rank{distributed.rank()}.pt"))
    distributed.barrier()
    distributed.destroy()


def zoo_spatial_single(name: str, out: str) -> dict:
    """Phase 16's reference for `name` in this process: its steps and eval
    forward without a group (the weights after the steps saved to
    out/zoo_<name>.pt for the ranks' eval; BiSeNet's and ICNet's
    multi-scale step too), the eval ids of those weights at float32
    compute (the yardstick of the eval ids), then from the same start
    step 1 once more as it is, and every step with `nudged_moments`, once
    with the BNs' batch means nudged and once with their means and mean
    squares; for ContextNet also step 1 through the plain versions with
    and without K2's folded bias one float32 step up (phase 15's
    yardstick). The yardsticks of the losses and of step 1's gradient are
    at each the largest of those gaps."""
    import torch
    model, single = zoo_spatial_run(name, sharded=False)
    single.pop("calls")
    torch.save(model.state_dict(), f"{out}/zoo_{name}.pt")
    single.update(spatial_eval(model, sharded=False, batch=ZS_BATCH,
                               size=ZS_EVAL_SIZE.get(name)))
    if name in ZS_MULTISCALE:
        single["multiscale"] = zoo_multiscale(model, sharded=False)
    if name == "bisenet":
        single["multiscale_bdd"] = zoo_multiscale(model, sharded=False,
                                                  size=ZS_BDD)
    # the eval ids' yardstick: the same weights at float32 compute (the
    # model's last use)
    for m in model.modules():
        if getattr(m, "compute_dtype", None) is not None:
            m.compute_dtype = torch.float32
    single["ids_f32"] = spatial_eval(model, sharded=False, batch=ZS_BATCH,
                                     dtype=torch.float32,
                                     size=ZS_EVAL_SIZE.get(name))["ids"]
    del model
    torch.cuda.empty_cache()
    runs = {}
    plans = [("again", contextlib.nullcontext, 1),
             ("means", nudged_moments, None),
             ("squares", functools.partial(nudged_moments, squares=True),
              None)]
    if name == "contextnet":
        plans += [("plain", functools.partial(swapped, plain_versions), 1),
                  ("k2_bias", functools.partial(swapped,
                                                nudged_plain_versions), 1)]
    for run, ctx, steps in plans:
        with ctx():
            model, runs[run] = zoo_spatial_run(name, sharded=False,
                                               steps=steps)
        del model
        torch.cuda.empty_cache()
    single["noise"] = rel_tree(runs["again"]["grads"], single["grads"])
    # each nudge against its own reference: K2's against the plain versions'
    pairs = {k: (runs[k], single) for k in ("means", "squares")}
    if "k2_bias" in runs:
        pairs["k2_bias"] = (runs["k2_bias"], runs["plain"])
    yards = {k: rel_tree(a["grads"], b["grads"]) for k, (a, b) in pairs.items()}
    decided = max(yards, key=yards.get)
    single["yards"] = yards
    single["yard"] = yards[decided]
    single["yard_by"] = decided
    single["yard_gaps"] = tree_gaps(*(r["grads"] for r in pairs[decided]))
    single["nudged_rels"] = {
        k: [abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"])]
        for k, (a, b) in pairs.items()}
    single["nudged_rel"] = [max(v) for v in zip(
        *single["nudged_rels"].values())]
    single["again_rel"] = abs(runs["again"]["losses"][0]
                              - single["losses"][0]) / abs(single["losses"][0])
    return single


def zoo_multiscale_check(name: str, bands: list, single: dict,
                         ids_bar: float, halos: int | None = None) -> dict:
    """The bands' multi-scale step (`zoo_multiscale`, one result a rank)
    against the single process's: each matrix counts every valid pixel
    once, no kernel launches, `halos` (ZS_MS_HALOS by default) halo
    exchanges a band, and half their L1 distance, a lower bound on the
    pixels whose id moved, is at most (1 − the eval ids' bar) of the
    valid pixels. Prints both mIoUs, step times and the bands' halo
    exchanges (gloo's: no speed figure)."""
    import torch
    valid = single["valid"]
    halos = ZS_MS_HALOS[name] if halos is None else halos
    fh, fw = single["size"]
    moved = int((bands[0]["cm"] - single["cm"]).abs().sum()) // 2
    bar = (1.0 - ids_bar) * valid
    for r, res in enumerate(bands):
        print(f"phase 16 {name} multi-scale + flip eval bf16 "
              f"{MULTISCALE_BATCH}x{fh}x{fw}, scales 0.5 .. 1.75, "
              f"rank {r} on a band of {fh // 2} rows (gloo; no speed "
              f"figure): mIoU {res['miou']:.6f}; one call {res['ms']:.1f} ms "
              f"on the host clock ({res['event_ms']:.1f} on CUDA events); "
              f"halo exchanges {res['halos']}; launches {res['launches']}; "
              f"matrix total {int(res['cm'].sum())} of {valid}", flush=True)
    print(f"phase 16 {name} multi-scale + flip eval, single process: mIoU "
          f"{single['miou']:.6f}; one call {single['ms']:.1f} ms on the host "
          f"clock ({single['event_ms']:.1f} on CUDA events); matrices "
          f"{moved} pixels apart (half their L1 distance; bar {bar:.1f}: "
          f"1 - {ids_bar:.6f} of the {valid} valid pixels)", flush=True)
    for res in [*bands, single]:
        if int(res["cm"].sum()) != valid or res["cm"].dtype != torch.int64:
            fail(f"phase 16 {name}: a multi-scale matrix holds "
                 f"{int(res['cm'].sum())} pixels, not the {valid} valid ones")
        if res["launches"]:
            fail(f"phase 16 {name}: the multi-scale step launched "
                 f"{res['launches']}")
    for r, res in enumerate(bands):
        if res["halos"] != halos:
            fail(f"phase 16 {name} rank {r}: the multi-scale call on "
                 f"{fh}x{fw} made {res['halos']} halo exchanges, expected "
                 f"{halos}")
    if not torch.equal(bands[0]["cm"], bands[1]["cm"]):
        fail(f"phase 16 {name}: the ranks' multi-scale matrices differ")
    if not moved <= bar:
        fail(f"phase 16 {name}: the bands' multi-scale matrix is {moved} "
             f"pixels from the single process's (bar {bar:.1f})")
    return {"moved": moved, "bar": bar, "bands": bands, "single": single}


def zoo_spatial_phase() -> dict:
    """Phase 16: each model's single-process reference, timed; then the
    two ranks, held against it: the losses at phase 14's bars, step 1's
    gradient within SP_GRAD_NOISE times the nudge yardstick, K3 1 + 1
    (DeepLab) or 3 + 3 (BiSeNet, ICNet), K4 4 (UNet), K1 1 + 1 (LEDNet,
    ContextNet), K2 12 + 12 and K6 1 + 1 (ContextNet) a step on each rank
    (ENet, ERFNet and ESNet launch no kernel), ZS_HALOS halo exchanges a
    step, the eval ids and matrix, and BiSeNet's and ICNet's multi-scale
    step (`zoo_multiscale_check`; BiSeNet's on BDD100K's 720x1280 too)."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        singles = {name: zoo_spatial_single(name, out) for name in ZS_STEPS}
        t_ranks = time.perf_counter()
        procs = spatial_processes(out, ZS_RANK_SCRIPT)
        try:
            for r, p in enumerate(procs):
                text = p.communicate(timeout=600)[0]
                if p.returncode != 0:
                    fail(f"rank {r} of phase 16 exited {p.returncode}:\n"
                         f"{text[-4000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        ranks = [torch.load(f"{out}/zoo_rank{r}.pt", weights_only=False)
                 for r in range(2)]
    ranks_s = time.perf_counter() - t_ranks
    result = {"ranks_s": ranks_s}
    for name, single in singles.items():
        got = [r[name] for r in ranks]
        want = single["losses"]
        rel = [abs(a - b) / abs(b) for a, b in zip(got[0]["losses"], want)]
        # phase 15's bars, or SP_GRAD_NOISE times the nudge's gap where
        # that is larger (set after DeepLab's first reading; the nudge of
        # the mean squares too after ICNet's, PERF.md §6)
        loss_bars = [max(DP_STEP1_RTOL if i == 0 else DP_LATER_RTOL,
                         SP_GRAD_NOISE * v)
                     for i, v in enumerate(single["nudged_rel"])]
        gap = rel_tree(got[0]["grads"], single["grads"])
        ids = torch.cat([r["ids"] for r in got], dim=1)
        share = float((ids == single["ids"].cpu()).float().mean())
        moved = int((got[0]["cm"] - single["cm"].cpu()).abs().sum()) // 2
        # the eval ids' bar: SP_IDS_SHARE, or SP_GRAD_NOISE times the share
        # on which this process's bf16 ids leave its float32 ones, where
        # that is larger (set after ENet's first reading, PERF.md §6)
        f32_miss = float((single["ids"] != single["ids_f32"]).float().mean())
        ids_bar = min(SP_IDS_SHARE, 1.0 - SP_GRAD_NOISE * f32_miss)
        miss = ids != single["ids"].cpu()
        h = ids.shape[1]
        # the bands' boundary in the ids' rows
        boundary = h * got[0]["eval_split"][0] // sum(got[0]["eval_split"])
        edge = float(miss[:, boundary - 8:boundary + 8].sum()) / max(
            1, int(miss.sum()))
        logits = torch.cat([r["logits"] for r in got], dim=1)
        lgap = float((logits - single["logits"].cpu()).abs().max())
        lscale = float(single["logits"].abs().max())
        (ch, cw), full = zs_crop(name), ZS_CONFIG_BATCH[name]
        cut = (f"its configuration's own" if full == ZS_BATCH else
               f"cut from {full} because every halo goes through host "
               f"memory under gloo")
        print(f"phase 16 {name} on two ranks of one card (gloo, "
              f"num_spatial=2, bands of {got[0]['split']} rows of "
              f"{ZS_BATCH}x{ch}x{cw}; batch {ZS_BATCH}, {cut}; not in the "
              f"kernels line):"
              f" losses {got[0]['losses']} (rank 1 "
              f"{got[1]['losses']}); single process {want}; relative gaps "
              f"{[f'{v:.3g}' for v in rel]} (bars "
              f"{[f'{v:.3g}' for v in loss_bars]}: {DP_STEP1_RTOL:g} at step "
              f"1 and {DP_LATER_RTOL:g} after, or {SP_GRAD_NOISE:g} x the "
              f"larger gaps of the single process's steps with every BN's "
              f"batch mean, or its mean and mean square, one float32 step "
              f"up: { {k: [f'{x:.3g}' for x in v] for k, v in single['nudged_rels'].items()} }"
              f"; its step 1 twice: {single['again_rel']:.3g})", flush=True)
        print(f"phase 16 {name} step 1's gradient against the single "
              f"process's: relative L2 over the tree {gap:.4g} ("
              f"{tree_gaps(got[0]['grads'], single['grads'])}); bar "
              f"{SP_GRAD_NOISE:g} x {single['yard']:.4g}, the largest of the "
              f"single process's step 1 with every BN's batch mean, or its "
              f"mean and mean square, one float32 step up"
              + (", or the plain versions' step 1 with K2's folded bias one "
                 "float32 step up against it unmoved" if "k2_bias" in
                 single["yards"] else "")
              + f" ({ {k: float(f'{v:.4g}') for k, v in single['yards'].items()} }"
              f"; decided by {single['yard_by']}: {single['yard_gaps']}); "
              f"the single process's step 1 twice: {single['noise']:.4g}",
              flush=True)
        for r, res in enumerate(got):
            extra = (f"; K4 against the unsharded K4's rows, max |diff| "
                     f"{res['k4_band']}" if name == "unet" else "")
            print(f"phase 16 {name} rank {r} (not in the kernels line): "
                  f"launches a step {[{k: v for k, v in c.items() if v} for c in res['launches']]}"
                  f"; eval {res['eval_launches']}; kernel vs plain on the "
                  f"last step's own inputs, worst relative L2 "
                  f"{ {k: float(f'{v:.3g}') for k, v in res['recorded'].items()} }"
                  + extra, flush=True)
            print(f"phase 16 {name} rank {r} halo exchanges a step "
                  f"{res['halos']} (expected {ZS_HALOS[name]}), bytes sent "
                  f"{res['halo_bytes']}", flush=True)
            print(f"phase 16 {name} rank {r} a band's step on CUDA events "
                  f"{[round(t, 3) for t in res['device_ms']]} ms (median "
                  f"{np.median(res['device_ms']):.3f})", flush=True)
            print(f"phase 16 {name} rank {r} max_memory_allocated "
                  f"{res['peak_bytes'] / 2 ** 30:.3f} GiB", flush=True)
        print(f"phase 16 {name} single process: step CUDA events "
              f"{[round(t, 3) for t in single['device_ms']]} ms; "
              f"max_memory_allocated {single['peak_bytes'] / 2 ** 30:.3f} "
              f"GiB; eval forward of the weights its steps reached, on the "
              f"bands and here: ids equal on {share:.6f} of the pixels (bar "
              f"{ids_bar:.6f}: {SP_IDS_SHARE} or 1 - {SP_GRAD_NOISE:g} x "
              f"{f32_miss:.6f}, the share on which this process's bf16 ids "
              f"leave its float32 ones); of the pixels that differ "
              f"{edge:.4f} lie within 8 rows of the bands' boundary (16 of "
              f"{h} rows); logits max |diff| {lgap:.4g} (scale "
              f"{lscale:.4g}); evaluate's matrix: {moved} pixels moved of "
              f"{int(single['cm'].sum())}", flush=True)
        want_launches = per_step(1, name)
        want_eval = ({"upsample_concat": 2 * K4_PER_FORWARD}
                     if name == "unet" else {})
        if name in ZS_K6:
            k6_step, k6_eval = ZS_K6[name]
            want_launches.update(depthwise_fwd=k6_step,
                                 depthwise_bwd=k6_step)
            want_eval = {"depthwise_fwd": 2 * k6_eval} if k6_eval else {}
        for r, res in enumerate(got):
            if any(steps != want_launches for steps in res["launches"]):
                fail(f"phase 16 {name} rank {r}'s launches "
                     f"{res['launches']}, expected {want_launches} a step")
            if res["eval_launches"] != want_eval:
                fail(f"phase 16 {name} rank {r}'s eval launches "
                     f"{res['eval_launches']}, expected {want_eval}")
            if any(h != ZS_HALOS[name] for h in res["halos"]):
                fail(f"phase 16 {name} rank {r}'s halo exchanges "
                     f"{res['halos']}, expected {ZS_HALOS[name]} a step")
            if res["losses"] != got[0]["losses"]:
                fail(f"phase 16 {name}: the ranks' losses differ: "
                     f"{[x['losses'] for x in got]}")
        if not all(np.isfinite(got[0]["losses"])) or any(
                v > b for v, b in zip(rel, loss_bars)):
            fail(f"phase 16 {name}: the spatial losses {got[0]['losses']} "
                 f"are off the single process's {want} (bars {loss_bars})")
        if not gap <= SP_GRAD_NOISE * single["yard"]:
            fail(f"phase 16 {name}: the spatial step's gradient is "
                 f"{gap:.4g} off the single process's (bar {SP_GRAD_NOISE:g}"
                 f" x {single['yard']:.4g})")
        if not share >= ids_bar or int(got[0]["cm"].sum()) != int(
                single["cm"].sum()):
            fail(f"phase 16 {name}: the spatial eval ids equal the single "
                 f"process's on {share} of the pixels (bar {ids_bar}); "
                 f"matrices of "
                 f"{int(got[0]['cm'].sum())} and {int(single['cm'].sum())} "
                 "pixels")
        if name in ZS_MULTISCALE:
            result[name + "_multiscale"] = zoo_multiscale_check(
                name, [r["multiscale"] for r in got], single["multiscale"],
                ids_bar)
        if name == "bisenet":
            result[name + "_multiscale_bdd"] = zoo_multiscale_check(
                name, [r["multiscale_bdd"] for r in got],
                single["multiscale_bdd"], ids_bar, ZS_MS_BDD_HALOS)
        result[name] = dict(ranks=got, single=single, rel=rel, grad_gap=gap,
                            ids_share=share, ids_bar=ids_bar)
    print(f"phase 16: ranks {ranks_s:.1f} s, phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return result


# phase 17: the zoo names compiled beside FastSCNN, at batch 2 of 512x1024,
# with their constructor keywords (the low-res logits where the
# constructor takes them; UNet's bilinear decoder, which runs K4)
AOT_ZOO_BATCH, AOT_ZOO_H, AOT_ZOO_W = 2, 512, 1024
AOT_ZOO = (UNET_BILINEAR,
           *((f"deeplabv3_resnet{d}", {"upsample_logits": False})
             for d in (18, 34, 50, 101)),
           ("enet", {}), ("bisenet", {"upsample_logits": False}),
           ("icnet", {"upsample_logits": False}),
           ("contextnet", {"upsample_logits": False}),
           ("lednet", {"upsample_logits": False}), ("erfnet", {}),
           ("esnet", {}))
# the kernel launches each capture holds, by the kernels line's names
# (none elsewhere)
AOT_HELD = {"fastscnn": {"sepconv": K5_PER_REQUEST},
            "unet": {"upsample_concat": K4_PER_FORWARD},
            "contextnet": {"sepconv": CONTEXTNET_K5_PER_REQUEST}}
# eager calls on the first batch: the eager predictor's own spread
AOT_EAGER_CALLS = 3


def host_copy_model():
    """A model whose forward copies a host array to the card: a CUDA graph
    cannot hold that, so `aot_compile` must raise."""
    import torch

    class HostCopy(torch.nn.Module):
        def forward(self, x):
            return x + torch.from_numpy(np.ones(3, np.float32)).to(x.device)

    return HostCopy()


def wrapper_launches(fn) -> dict:
    """The kernels' launches during `fn()`, by the kernels line's names
    (those that launched)."""
    from torch_semantic_segmentation_tpu_torch import profiling
    before = profiling.launch_counts()
    fn()
    after = profiling.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def aot_outputs(name: str, predict, compiled, frames: list) -> dict:
    """The eager predictor's outputs on each batch (`AOT_EAGER_CALLS` times
    on the first: its own spread, the most elements two of its calls
    differ on) against the compiled outputs: fail unless they differ on no
    more elements than that spread, and unless the capture holds the
    launches of one eager request, `AOT_HELD`'s."""
    import torch
    eager = [predict(frames[0]) for _ in range(AOT_EAGER_CALLS)]
    eager += [predict(f) for f in frames[1:]]
    a_request = wrapper_launches(lambda: predict(frames[0]))
    got = [compiled(f) for f in frames]
    torch.cuda.synchronize()
    spread = max(int((e != eager[0]).sum()) for e in eager[1:AOT_EAGER_CALLS])
    want = [eager[0]] + eager[AOT_EAGER_CALLS:]
    diff = [int((g != w).sum()) for g, w in zip(got, want)]
    held = AOT_HELD.get(name, {})
    what = f"phase 17 {name} {predict.output}"
    if compiled.held != held or a_request != held:
        fail(f"{what}: the capture holds {compiled.held}, an eager request "
             f"launches {a_request}, expected {held}")
    if not all(torch.isfinite(g.float()).all() for g in got):
        fail(f"{what}: the compiled outputs are not finite")
    if max(diff) > spread:
        fail(f"{what}: the compiled outputs differ from the eager ones on "
             f"{diff} elements a batch of {got[0].numel()}; the eager "
             f"predictor's own spread is {spread}")
    return dict(diff=diff, spread=spread, got=got, want=want)


def classes_present(ids) -> int:
    import torch
    return int((torch.bincount(ids.flatten().long()) > 0).sum())


def aot_phase() -> dict:
    """Phase 17, ahead-of-time serving: FastSCNN at phase 4's
    configuration compiled by `serving.aot_compile` (one CUDA graph):
    its capture's K5 launches, the compiled ids on two batches against the
    eager predictor's bit for bit, the first result unchanged after the
    second call, a wrong shape refused; 5 requests of each predictor on
    the host clock and CUDA events, the compile's time and each
    predictor's peak memory; then every other zoo name at batch 2 of
    512x1024, its compiled ids and logits against its eager ones (bar:
    the eager predictor's own spread, 0 where two of its calls agree),
    K4's 4 launches in UNet's captures and K5's 4 in ContextNet's; last,
    a capture that fails (a host copy in the forward) raises, and the
    eager predictor then serves its ids."""
    import torch
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        normalize_batch)
    from torch_semantic_segmentation_tpu_torch.models import get_model
    from torch_semantic_segmentation_tpu_torch.serving import (
        WARMUP_CALLS, aot_compile, make_predict_fn)

    t0 = time.perf_counter()
    smi = smi_line()
    frames = [torch.from_numpy(make_frames(s)).cuda() for s in (0, 1)]
    predict = make_predict_fn(build_model(torch.bfloat16,
                                          calibrated_state(frames[0])),
                              output="ids")
    predict(frames[0])                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, eager_host, eager_dev = request_times(predict, frames[0], REQUESTS)
    eager_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    compiled = aot_compile(predict, SERVE_BATCH, SERVE_H, SERVE_W)
    # the graph's private pool: reserved for the graph, never counted as
    # allocated during a replay
    graph_bytes = torch.cuda.memory_reserved() - reserved
    ids = aot_outputs("fastscnn", predict, compiled, frames)
    ids["present"] = classes_present(ids["want"][0])
    kept = torch.equal(ids["got"][0], ids["want"][0])
    try:
        compiled(frames[0][:SERVE_BATCH - 1])
        refused = False
    except TypeError:
        refused = True
    torch.cuda.reset_peak_memory_stats()
    _, aot_host, aot_dev = request_times(compiled, frames[0], REQUESTS)
    aot_peak = torch.cuda.max_memory_allocated()
    print(f"phase 17 fastscnn bf16 {SERVE_BATCH}x{SERVE_H}x{SERVE_W} ({smi}):"
          f" aot_compile {compiled.seconds:.3f} s ({WARMUP_CALLS} warm-up "
          f"calls and the capture), memory reserved for it "
          f"{graph_bytes / 2 ** 30:.3f} GiB; capture holds {compiled.held}; "
          f"compiled ids against eager on two batches: {ids['diff']} pixels "
          f"differ (eager spread {ids['spread']}, {ids['present']} classes "
          f"present); the first result unchanged after the second call: "
          f"{kept}; a batch of {SERVE_BATCH - 1} refused with TypeError: "
          f"{refused}", flush=True)
    print(f"phase 17 fastscnn request ms ({smi}): eager host "
          f"{[round(t, 3) for t in eager_host]} median "
          f"{np.median(eager_host):.3f}, CUDA events median "
          f"{np.median(eager_dev):.3f}, peak {eager_peak / 2 ** 30:.3f} GiB; "
          f"compiled host {[round(t, 3) for t in aot_host]} median "
          f"{np.median(aot_host):.3f}, CUDA events median "
          f"{np.median(aot_dev):.3f}, peak {aot_peak / 2 ** 30:.3f} GiB "
          f"allocated + {graph_bytes / 2 ** 30:.3f} GiB reserved for the "
          f"graph", flush=True)
    if ids["diff"] != [0, 0] or not kept or not refused:
        fail("phase 17: FastSCNN's compiled ids differ from the eager ids, "
             "the first result moved after the second call, or a wrong "
             "shape was not refused")
    eager_first = ids["want"][0]
    # each graph's kernel launches and replays, for the kernels line
    out = {"fastscnn": dict(held=compiled.held, replays=compiled.replays)}
    del compiled, ids
    torch.cuda.empty_cache()

    batch = (AOT_ZOO_BATCH, AOT_ZOO_H, AOT_ZOO_W)
    zoo_frames = [f[:AOT_ZOO_BATCH, :AOT_ZOO_H, :AOT_ZOO_W].contiguous()
                  for f in frames]
    for name, kw in AOT_ZOO:
        t1 = time.perf_counter()
        model = get_model(name, NUM_CLASSES, seed=0, device="cuda",
                          compute_dtype=torch.bfloat16, **kw)
        calibrate_bn(model, normalize_batch(zoo_frames[0]))
        # the ids and, since a random deep model may give every pixel one
        # class, the logits too (`make_predict_fn` folds once)
        for output in ("ids", "logits"):
            zpredict = make_predict_fn(model, output=output)
            zpredict(zoo_frames[0])          # warm-up
            zcompiled = aot_compile(zpredict, *batch)
            got = aot_outputs(name, zpredict, zcompiled, zoo_frames)
            present = (f"; {classes_present(got['want'][0])} classes present"
                       if output == "ids" else "")
            print(f"phase 17 {name} bf16 {'x'.join(map(str, batch))} "
                  f"{output}: aot_compile {zcompiled.seconds:.3f} s; capture "
                  f"holds {zcompiled.held}; compiled against eager: "
                  f"{got['diff']} elements differ of {got['want'][0].numel()}"
                  f", eager spread {got['spread']} (the bar){present}; "
                  f"{time.perf_counter() - t1:.1f} s", flush=True)
            out[name if output == "ids" else f"{name}_{output}"] = dict(
                held=zcompiled.held, replays=zcompiled.replays)
            del zpredict, zcompiled, got
        del model
        torch.cuda.empty_cache()

    bad = make_predict_fn(host_copy_model(), fold_bn=False, output="logits")
    try:
        aot_compile(bad, 1, 64, 64)
    except RuntimeError as err:
        print(f"phase 17 a failed capture raises: {str(err)[:400]}",
              flush=True)
    else:
        fail("phase 17: the capture of a host copy did not raise")
    if not torch.equal(predict(frames[0]), eager_first):
        fail("phase 17: after the failed capture the eager ids moved")
    print(f"phase 17: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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

    t_script = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"device: {name} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)

    # one nvcc for each source, all started together
    t0 = time.perf_counter()
    names = ("sepconv", "resize_ce", "mbconv", "depthwise", "upsample_concat")
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
    k6 = check_depthwise()
    k4 = check_upsample_concat()
    k3 = check_resize_ce_map()
    check_resize_ce_nan()
    served = serve()
    train()
    main_path = train_augmented()
    model = main_path.pop("model")
    remat = remat_check(model, *main_path.pop("batch"))
    eval_check(model)
    del model
    torch.cuda.empty_cache()
    unet = unet_phase()
    deeplab = deeplab_phase()
    config5 = {name: config5_phase(name, depth)
               for name, depth in CONFIG5_MODELS}
    enet_phase()
    stretch = {name: stretch_phase(name) for name in STRETCH_MODELS}
    fed = pipeline_phase(main_path["latency_ms"])
    cli = cli_phase(remat["launches"]["True"])
    dp = dp_phase(main_path)
    print(f"dp launches (phase 14, not in the kernels line): group of one "
          f"{dp['group_of_one']['launches']} in {TRAIN_STEPS} steps; each "
          f"of the two ranks {per_step(DP_CLI_STEPS)} in {DP_CLI_STEPS} "
          f"steps", flush=True)
    sp = spatial_phase(main_path)
    print(f"spatial launches (phase 15, not in the kernels line): each of "
          f"the two ranks {sp['ranks'][0]['launches']} in {SP_STEPS} steps",
          flush=True)
    zoo_spatial_phase()
    aot = aot_phase()

    def row(kname, source, replaces, launches, r):
        return {"name": kname, "route": "cuda",
                "source": f"torch_semantic_segmentation_tpu_torch/csrc/{source}",
                "replaces": f"torch_semantic_segmentation_tpu/ops/{replaces}",
                "launches": launches, "max_abs_err": r["err"],
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]}

    # K1's, K2's and K6's paths: FastSCNN's main path and the stretch
    # models'; the rows' times at FastSCNN's shapes, each path's under
    # "paths"
    train_paths = {"fastscnn": main_path, "fastscnn_pipeline": fed, **{
        name: stretch[name]["train"] for name in STRETCH_MODELS},
        **cli["runs"]}

    def path_row(kname, source, replaces, d, checks):
        paths = [(p, train_paths[p]["launches"][kname]) for p in checks]
        r = row(kname, source, replaces, sum(n for _, n in paths),
                checks["fastscnn"][d])
        r["paths"] = [
            {"path": p, "launches": n,
             "launches_a_step": per_step(1, p)[kname],
             "ms": checks[p][d]["kernel_ms"],
             "plain_ms": checks[p][d]["plain_ms"],
             "bound_ms": checks[p][d]["bound_ms"],
             "library_ms": checks[p][d]["library_ms"],
             "max_abs_err": checks[p][d]["err"]}
            for p, n in paths]
        return r

    # K5's paths: FastSCNN's request (the row's numbers, the mean of its
    # three launches) and ContextNet's four (d=4 once, d=1 three times)
    cases = k5["cases"]
    d1 = [cases["classifier.ds1"], cases["classifier.ds2"]]
    k5_ctx = {key: (cases["ffm"][key] + 1.5 * sum(c[key] for c in d1)) / 4
              for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    k5_ctx["err"] = max(c["err"] for c in d1 + [cases["ffm"]])
    k5_row = row("sepconv", "sepconv.cu", "pallas_sepconv.py:239",
                 served["launches"]
                 + stretch["contextnet"]["serve"]["sepconv_launches"], k5)
    # the kernels' launches inside phase 17's graphs: a replay launches
    # them again, and no wrapper counts it
    def graphs(wrapper: str) -> list:
        return [{"path": f"{p}_aot", "held": r["held"][wrapper],
                 "replays": r["replays"]}
                for p, r in aot.items() if wrapper in r["held"]]

    k5_row["graphs"] = graphs("sepconv")
    k5_row["paths"] = [
        {"path": p, "launches": n, "launches_a_request": per_request,
         "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "library_ms": r["library_ms"],
         "max_abs_err": r["err"]}
        for p, n, per_request, r in (
            ("fastscnn", served["launches"], K5_PER_REQUEST, k5),
            ("contextnet", stretch["contextnet"]["serve"]["sepconv_launches"],
             CONTEXTNET_K5_PER_REQUEST, k5_ctx))]
    # phase 12 runs FastSCNN's step at the shapes of phase 6: its rows'
    # times are FastSCNN's
    k1_paths = {p: k1[p] for p in ("fastscnn", "lednet", "contextnet")}
    k1_paths["fastscnn_pipeline"] = k1["fastscnn"]
    k1_paths["cli_fused"] = k1["cli_fused"]
    k26_paths = ("fastscnn", "contextnet")

    def k26(checks):
        return {**{p: checks[p] for p in k26_paths},
                "fastscnn_pipeline": checks["fastscnn"]}

    # phase 13's accuracy runs launch K2 at the nine small GFE shapes
    k2_paths = {**k26(k2), "cli_default": k2["cli"], "cli_fused": k2["cli"]}
    # K3's paths: DeepLab's one head and config 5's three; the row's times
    # at DeepLab's x16, each path's own under "paths"
    k3_train = {"deeplab": deeplab["train"], **{
        name: config5[name]["train"] for name, _ in CONFIG5_MODELS}}

    def k3_row(kname, replaces, d):
        r = row(kname, "resize_ce.cu", replaces, sum(
            t["launches"][kname] for t in k3_train.values()), k3["deeplab"][d])
        r["paths"] = [
            {"path": p, "launches": t["launches"][kname],
             "launches_a_step": K3_PER_STEP[p], "ms": k3[p][d]["kernel_ms"],
             "plain_ms": k3[p][d]["plain_ms"],
             "bound_ms": k3[p][d]["bound_ms"],
             "library_ms": k3[p][d]["library_ms"],
             "max_abs_err": k3[p][d]["err"]}
            for p, t in k3_train.items()]
        return r

    print(f"chip_smoke: all phases {time.perf_counter() - t_script:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [
        k5_row,
        path_row("resize_ce_fwd", "resize_ce.cu", "pallas_resize_ce.py:329",
                 "fwd", k1_paths),
        path_row("resize_ce_bwd", "resize_ce.cu", "pallas_resize_ce.py:381",
                 "bwd", k1_paths),
        path_row("mbconv_fwd", "mbconv.cu", "pallas_mbconv.py:337", "fwd",
                 k2_paths),
        path_row("mbconv_bwd", "mbconv.cu", "pallas_mbconv.py:394", "bwd",
                 k2_paths),
        path_row("depthwise_fwd", "depthwise.cu", "pallas_dw.py:405", "fwd",
                 k26(k6)),
        path_row("depthwise_bwd", "depthwise.cu", "pallas_dw.py:452", "bwd",
                 k26(k6)),
        {**row("upsample_concat", "upsample_concat.cu",
               "pallas_upsample.py:109",
               unet["train"]["launches"]["upsample_concat"], k4),
         "graphs": graphs("upsample_concat")},
        k3_row("resize_ce_map_fwd", "pallas_resize_ce.py:446", "fwd"),
        k3_row("resize_ce_map_bwd", "pallas_resize_ce.py:494", "bwd"),
    ]}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
