"""Ranks of the port's data-parallel tests (`tests/test_torch_parallel*.py`,
`tests/test_torch_multihost_cli.py`, `tests/test_torch_spatial*.py`).
It imports only the port, torch and numpy.

    python tests/torch_mp_worker.py SUITE RANK WORLD STORE OUTDIR

joins a gloo group of WORLD ranks through `file://STORE` (SUITE
"spatial:S", "zoo:S", "dec:S", "cas:S", "str:S" or "ms:S" with
`num_spatial=S`: each rank on a band of H rows), runs every case of SUITE on its rows of each
case's global batch and saves {case: result} to OUTDIR/rank<RANK>.pt.
The parent test runs the same case functions in its own process without
a group, where they see the whole batch, and compares.

Each case builds its global inputs from a seed with numpy, takes the
rank's rows (`parallel.shard_batch`), runs, and returns a dict of tensors.
A loss case returns the rank's share of the loss and the gradients of that
share: the shares sum over ranks to the single-process loss, the input
gradients are the rank's rows of the single-process ones, and parameter
gradients are the rank's parts, which sum to the single process's.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from torch_semantic_segmentation_tpu_torch import checkpoint, losses
from torch_semantic_segmentation_tpu_torch.parallel import (
    distributed, shard_batch)

C = 5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(*arrays):
    return shard_batch(tuple(_t(a) for a in arrays))


# --- suite "parallel": the layers, the losses, the draws, the matrix ---

def case_bn() -> dict:
    from torch_semantic_segmentation_tpu_torch.ops.conv import make_norm
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 6, 5, 8)) * 3 + 1).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    x, g = _rows(x, g)
    x.requires_grad_(True)
    bn = make_norm(8)
    with torch.no_grad():
        bn.weight.copy_(_t(rng.uniform(0.5, 1.5, 8).astype(np.float32)))
        bn.bias.copy_(_t(rng.normal(size=8).astype(np.float32)))
    bn.train()
    y = bn(x)
    (y * g).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad,
            "dbias": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}


def case_folded() -> dict:
    from torch_semantic_segmentation_tpu_torch.ops.conv import (
        make_conv, make_norm)
    from torch_semantic_segmentation_tpu_torch.ops.folded_bn import (
        folded_1x1_weights)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 5, 5, 6)).astype(np.float32) + 0.5
    (x,) = _rows(x)
    x.requires_grad_(True)
    conv = make_conv(6, 10, 1, use_bias=True,
                     generator=torch.Generator().manual_seed(3))
    bn = make_norm(10)
    a = _t(rng.normal(size=(6, 10)).astype(np.float32))
    b = _t(rng.normal(size=10).astype(np.float32))
    wf, bf = folded_1x1_weights(conv, bn, x)
    # every rank computes the same W′, b′: each backpropagates 1/R of a
    # loss of them, and the shares sum to the single process's
    share = ((wf * a).sum() + (bf * b).sum()) / distributed.world_size()
    share.backward()
    return {"w": wf.detach(), "b": bf.detach(), "dx": x.grad,
            "dconv": conv.weight.grad, "dconv_bias": conv.bias.grad,
            "dgamma": bn.weight.grad, "dbeta": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def _labels(rng, shape, pattern: str):
    """(N, H, W) int32 labels of `pattern`: "rank1_ignored" leaves the
    second half of the batch all 255; "unequal" ignores a different share
    of each image."""
    y = rng.integers(0, C, shape).astype(np.int32)
    n = shape[0]
    if pattern == "rank1_ignored":
        y[n // 2:] = 255
    else:
        for i in range(n):
            y[i][rng.random(shape[1:]) < 0.2 * i] = 255
    return y


LOSS_CASES = [(fn, pattern, weighted)
              for fn in ("ce", "k1", "resize_plain")
              for pattern in ("rank1_ignored", "unequal")
              for weighted in (False, True)]


def _loss_case(fn: str, pattern: str, weighted: bool) -> dict:
    rng = np.random.default_rng(10 + LOSS_CASES.index((fn, pattern,
                                                       weighted)))
    cw = (torch.from_numpy(rng.uniform(0.5, 2.0, C).astype(np.float32))
          if weighted else None)
    if fn == "ce":
        logits = rng.normal(size=(4, 8, 6, C)).astype(np.float32) * 2
        labels = _labels(rng, (4, 8, 6), pattern)
    else:
        logits = rng.normal(size=(4, 4, 3, C)).astype(np.float32) * 2
        labels = _labels(rng, (4, 16, 12), pattern)
    logits, labels = _rows(logits, labels)
    if fn == "k1":
        logits = logits.to(torch.bfloat16)
    logits.requires_grad_(True)
    if fn == "ce":
        share = losses.cross_entropy_loss(logits, labels, class_weights=cw)
    else:
        share = losses.resize_cross_entropy_loss(logits, labels,
                                                 class_weights=cw)
    share.backward()
    return {"share": share.detach(), "dlogits": logits.grad.float()}


OHEM_CASES = [("ohem", True), ("ohem", False), ("resize_ohem", None),
              ("resize_ohem_f32", None)]


def ohem_inputs(fn: str, exact):
    """The global (logits, labels, keywords) of an OHEM case. min_kept is
    60% of the global batch's pixels: more than one rank's valid pixels,
    and above the count that thresh 0.3 keeps, so it decides."""
    rng = np.random.default_rng(30 + OHEM_CASES.index((fn, exact)))
    if fn == "ohem":
        logits = rng.normal(size=(4, 8, 8, C)).astype(np.float32) * 2
        labels = _labels(rng, (4, 8, 8), "unequal")
    else:
        logits = rng.normal(size=(4, 4, 4, C)).astype(np.float32) * 2
        labels = _labels(rng, (4, 16, 16), "unequal")
    return logits, labels, dict(thresh=0.3, min_kept=int(0.6 * labels.size))


def _ohem_case(fn: str, exact) -> dict:
    logits, labels, kw = ohem_inputs(fn, exact)
    logits, labels = _rows(logits, labels)
    if fn == "resize_ohem":
        logits = logits.to(torch.bfloat16)
    logits.requires_grad_(True)
    if fn == "ohem":
        share = losses.ohem_cross_entropy(logits, labels, exact=exact, **kw)
    else:
        share = losses.resize_ohem_cross_entropy(logits, labels, **kw)
    share.backward()
    return {"share": share.detach(), "dlogits": logits.grad.float(),
            "min_kept": torch.tensor(kw["min_kept"])}


def case_draws() -> dict:
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        AugmentConfig, augment_batch)
    from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (4, 40, 48, 3)).astype(np.uint8)
    labels = rng.integers(0, C, (4, 40, 48)).astype(np.uint8)
    x = rng.normal(size=(4, 6, 6, 8)).astype(np.float32)
    frames, labels, x = _rows(frames, labels, x)
    gen = torch.Generator().manual_seed(5)
    out = {}
    for i in range(2):   # two batches: the generator stays in step
        img, lbl = augment_batch(frames, labels, gen,
                                 AugmentConfig(crop=(32, 32), hue=0.1))
        out[f"images{i}"], out[f"labels{i}"] = img, lbl
    for name, dims in (("dropout", ()), ("spatial", (1, 2))):
        drop = Dropout(0.5, broadcast_dims=dims,
                       generator=torch.Generator().manual_seed(6))
        drop.train()
        out[name] = torch.cat([drop(x), drop(x)])
    out["generator"] = gen.get_state()
    return out


class _PixelClassifier(torch.nn.Module):
    """A 1×1 linear map from RGB to C logits (NHWC), for the eval step."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(7)
        self.w = torch.nn.Parameter(torch.randn(3, C, generator=g))

    def forward(self, x):
        return x @ self.w


def case_eval() -> dict:
    from torch_semantic_segmentation_tpu_torch.eval import evaluate
    from torch_semantic_segmentation_tpu_torch.train import make_eval_step
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(3):
        x = rng.normal(size=(4, 10, 12, 3)).astype(np.float32)
        y = _labels(rng, (4, 10, 12), "unequal")
        batches.append(_rows(x, y))
    step = make_eval_step(_PixelClassifier(), num_classes=C, device="cpu")
    _, miou, cm = evaluate(step, batches, num_classes=C, device="cpu")
    return {"cm": cm, "miou": torch.tensor(miou, dtype=torch.float64)}


def case_shard_range() -> dict:
    out = {"range8": torch.tensor(distributed.local_shard_range(8))}
    try:
        distributed.local_shard_range(3)
        out["raised"] = torch.tensor(False)
    except ValueError:
        out["raised"] = torch.tensor(True)
    return out


def case_loader() -> dict:
    """The rank's input stream (`local_batch_iterator`): two global
    batches of 4 from a shuffled dataset of 10, the rank's rows of each."""
    rng = np.random.default_rng(9)
    dataset = [(rng.integers(0, 256, (6, 8, 3)).astype(np.uint8),
                rng.integers(0, C, (6, 8)).astype(np.uint8))
               for _ in range(10)]
    it = distributed.local_batch_iterator(dataset, 4, device="cpu", seed=3,
                                          start_batch=1, num_threads=2)
    out = {}
    for i in range(2):
        out[f"images{i}"], out[f"labels{i}"] = next(it)
    return out


def suite_parallel() -> dict:
    res = {"bn": case_bn(), "folded": case_folded(), "draws": case_draws(),
           "eval": case_eval(), "shard_range": case_shard_range(),
           "loader": case_loader()}
    for key in LOSS_CASES:
        res["loss-" + "-".join(map(str, key))] = _loss_case(*key)
    for key in OHEM_CASES:
        res["ohem-" + "-".join(map(str, key))] = _ohem_case(*key)
    return res


# --- suite "step": whole training steps ---

STEP_N, STEP_H, STEP_W, STEP_C = 4, 64, 128, 19
LR = 0.002


def step_batches(steps: int, *, n=STEP_N, h=STEP_H, w=STEP_W, c=STEP_C,
                 seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        x = rng.normal(size=(n, h, w, 3)).astype(np.float32)
        y = rng.integers(0, c, (n, h, w)).astype(np.int32)
        y[:, :4, :9] = 255
        out.append((x, y))
    return out


def run_steps(model, loss_fn, batches) -> dict:
    """SGD steps (LR 0.002, max_steps 4) on the rank's rows of each batch:
    the losses, and the state after the first and the last step."""
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)
    state = create_train_state(model, OptimizerConfig(lr=LR, max_steps=4))
    step = make_train_step(model, state, loss_fn, device="cpu")
    out = {"losses": []}
    for i, batch in enumerate(batches):
        out["losses"].append(step(*_rows(*batch))["loss"])
        if i in (0, len(batches) - 1):
            out[f"state{i + 1}"] = {k: v.clone() for k, v in
                                    model.state_dict().items()}
    out["losses"] = torch.stack(out["losses"])
    return out


def fastscnn_model(init: str | None, compute_dtype=None):
    from torch_semantic_segmentation_tpu_torch.models import fastscnn
    m = fastscnn(STEP_C, upsample_logits=False, compute_dtype=compute_dtype,
                 device="cpu")
    if init is not None:
        m.load_state_dict(torch.load(init, weights_only=True))
    m.classifier.dropout.rate = 0.0
    return m


def enet_model():
    from torch_semantic_segmentation_tpu_torch.models import get_model
    return get_model("enet", STEP_C, device="cpu")


def case_fastscnn_f32(init) -> dict:
    return run_steps(fastscnn_model(init), losses.resize_cross_entropy_loss,
                     step_batches(3))


def case_fastscnn_bf16(init) -> dict:
    return run_steps(fastscnn_model(init, torch.bfloat16),
                     losses.resize_cross_entropy_loss, step_batches(2))


def case_enet() -> dict:
    model = enet_model()
    out = run_steps(model, losses.cross_entropy_loss,
                    step_batches(2, h=32, w=32, seed=1))
    out["dropout_generator"] = model.dropout_generator.get_state()
    return out


def case_checked_nan(init) -> dict:
    """One good step, then one whose batch has a NaN pixel (in rank 0's
    rows): the checked step raises on every rank and leaves the state."""
    from torch_semantic_segmentation_tpu_torch.debug import checked_step
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)
    model = fastscnn_model(init)
    state = create_train_state(model, OptimizerConfig(lr=LR, max_steps=4))
    step = checked_step(make_train_step(
        model, state, losses.resize_cross_entropy_loss, device="cpu"))
    (x, y), (x2, y2) = step_batches(2, h=32, w=32, seed=2)
    step(*_rows(x, y))
    before = ({k: v.clone() for k, v in model.state_dict().items()},
              [b.clone() for b in _momenta(state)],
              state.scheduler.state_dict())
    x2[0, 5, 5, 1] = np.nan
    try:
        step(*_rows(x2, y2))
        raised = ""
    except FloatingPointError as e:
        raised = str(e)
    after = model.state_dict()
    same = (all(torch.equal(v, after[k]) for k, v in before[0].items())
            and all(torch.equal(a, b) for a, b in
                    zip(before[1], _momenta(state), strict=True))
            and before[2] == state.scheduler.state_dict())
    return {"raised": raised, "unchanged": torch.tensor(same)}


def _momenta(state):
    opt = state.optimizer
    return [opt.state[p]["momentum_buffer"]
            for g in opt.param_groups for p in g["params"]]


def suite_step(outdir: str) -> dict:
    init = os.path.join(outdir, "init.pt")
    return {"init": init, "fastscnn_f32": case_fastscnn_f32(init),
            "fastscnn_bf16": case_fastscnn_bf16(init),
            "enet": case_enet(), "checked_nan": case_checked_nan(init)}


# --- suite "spatial:S": FastSCNN on H bands (num_spatial=S) ---

SP_N, SP_H, SP_W, SP_C = 2, 128, 64, 5


def spatial_batch(seed: int = 7):
    """A global batch of SP_N images (float32 NHWC, int32 labels), with
    ignored labels across the middle band boundary and at the top."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(SP_N, SP_H, SP_W, 3)).astype(np.float32)
    y = rng.integers(0, SP_C, (SP_N, SP_H, SP_W)).astype(np.int32)
    y[:, :6, :9] = 255
    y[:, 60:70, 20:30] = 255
    return x, y


def _bands(*arrays, max_stride: int = 32):
    """The rank's band of its rows of each global array (the arrays
    themselves without a group), after the guards at `max_stride`."""
    return shard_batch(tuple(_t(a) for a in arrays), spatial=True,
                       max_stride=max_stride)


def spatial_model(init: str, upsample_logits: bool, compute_dtype=None):
    from torch_semantic_segmentation_tpu_torch.models import fastscnn
    m = fastscnn(SP_C, upsample_logits=upsample_logits,
                 compute_dtype=compute_dtype, device="cpu")
    m.load_state_dict(torch.load(init, weights_only=True))
    m.classifier.dropout.rate = 0.0
    return m


def case_spatial_eval(outdir: str) -> dict:
    """The eval forward's logits (full resolution) of the rank's band, on
    the JAX package's spatial test's model and input (`fwd_init.pt`,
    `synthetic_batch(2, 128, 64, 5, seed=7)`), and `evaluate`'s matrix over
    two batches on both heads (full-resolution logits, and 1/8 logits
    through the ×8 resize + argmax) with BN calibrated (`eval_init.pt`)."""
    from torch_semantic_segmentation_tpu_torch.data.synthetic import (
        synthetic_batch)
    from torch_semantic_segmentation_tpu_torch.eval import evaluate
    from torch_semantic_segmentation_tpu_torch.train import make_eval_step
    m = spatial_model(os.path.join(outdir, "fwd_init.pt"), True).eval()
    x, _ = _bands(*synthetic_batch(SP_N, SP_H, SP_W, SP_C, seed=7))
    with torch.no_grad():
        out = {"logits": m(x)}
    init = os.path.join(outdir, "eval_init.pt")
    for up in (True, False):
        step = make_eval_step(spatial_model(init, up), num_classes=SP_C,
                              device="cpu")
        batches = [_bands(*spatial_batch(seed)) for seed in (8, 9)]
        out[f"cm_{up}"] = evaluate(step, batches, num_classes=SP_C,
                                   device="cpu")[2]
    return out


def case_spatial_grads(outdir: str, upsample_logits: bool,
                       compute_dtype=None) -> dict:
    """One train-mode forward and backward: the global loss (the shares
    summed), the parameter gradients summed over ranks, the band's input
    gradient, the BN statistics after it and the halo exchanges it made.
    Full-resolution logits take plain CE (the JAX package's spatial test's
    route), 1/8 logits the resize CE (K1's plain version in bf16)."""
    from torch_semantic_segmentation_tpu_torch.ops import blocks
    m = spatial_model(os.path.join(outdir, "init.pt"), upsample_logits,
                      compute_dtype).train()
    x, y = _bands(*spatial_batch())
    x.requires_grad_(True)
    loss_fn = (losses.cross_entropy_loss if upsample_logits
               else losses.resize_cross_entropy_loss)
    routed = []
    real = blocks.fused_expand_dw

    def counted(*args):
        routed.append(args[0].shape)
        return real(*args)

    blocks.fused_expand_dw = counted
    h0 = distributed.halo_exchanges
    try:
        share = loss_fn(m(x), y)
        share.backward()
    finally:
        blocks.fused_expand_dw = real
    distributed.all_reduce_gradients(m.parameters())
    return {"loss": distributed.reduce_sum(share.detach()),
            "grads": {k: p.grad.clone() for k, p in m.named_parameters()},
            "dx": x.grad, "k2_routed": torch.tensor(len(routed)),
            "halo_exchanges": torch.tensor(distributed.halo_exchanges - h0),
            "stats": {k: v.clone() for k, v in m.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


def case_spatial_steps(outdir: str) -> dict:
    """Two SGD steps (LR 0.002) through `make_train_step` on the fused
    route: the losses and the state after each."""
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)
    model = spatial_model(os.path.join(outdir, "init.pt"), False)
    state = create_train_state(model, OptimizerConfig(lr=LR, max_steps=4))
    step = make_train_step(model, state, losses.resize_cross_entropy_loss,
                           device="cpu")
    out = {"losses": []}
    for i, seed in enumerate((7, 10)):
        out["losses"].append(step(*_bands(*spatial_batch(seed)))["loss"])
        out[f"state{i + 1}"] = {k: v.clone() for k, v in
                                model.state_dict().items()}
    out["losses"] = torch.stack(out["losses"])
    return out


def case_spatial_dropout() -> dict:
    """Train-mode dropout (element and spatial) of the band: rows of the
    single process's masks."""
    from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout
    rng = np.random.default_rng(11)
    (x,) = _bands(rng.normal(size=(SP_N, 64, 8, 4)).astype(np.float32))
    out = {}
    for name, dims in (("dropout", ()), ("spatial", (1, 2))):
        drop = Dropout(0.5, broadcast_dims=dims,
                       generator=torch.Generator().manual_seed(6))
        drop.train()
        out[name] = torch.cat([drop(x), drop(x)])
    return out


def suite_spatial(outdir: str, grads_only: bool = False) -> dict:
    grads = {"grads_full": case_spatial_grads(outdir, True),
             "grads_low": case_spatial_grads(outdir, False)}
    if grads_only:
        return grads
    return {**grads, "eval": case_spatial_eval(outdir),
            "grads_bf16": case_spatial_grads(outdir, False, torch.bfloat16),
            "steps": case_spatial_steps(outdir),
            "dropout": case_spatial_dropout()}


# --- suite "zoo:S": DeepLabV3 and UNet on H bands (num_spatial=S) ---

ZOO_N, ZOO_H, ZOO_W = 2, 128, 64         # the JAX package's spatial test
ZOO_STEP_N = 4     # ASPP's image-level BN normalises over N values a channel
ZOO_UNET = dict(base_ch=8)
# OHEM that selects: about half the pixels lie below -log(0.2), and
# min_kept (60% of the batch's pixels) moves the threshold under that
ZOO_OHEM = dict(thresh=0.2, min_kept=int(0.6 * ZOO_STEP_N * ZOO_H * ZOO_W))
# (top, bottom) of the halo cases, in band rows R: less than a band, a
# band, past the next band, and past every band of 4
HALO_CASES = [(0.5, 0.5), (1, 1), (1.25, 0.25), (0, 1.25), (2.25, 3)]
# (kernel, stride, dilation) of the on_band cases: dilated 3x3s reaching
# half a band, past the next band and past two, ResNet's stem
ON_BAND_CASES = [(3, 1, 0.5), (3, 1, 1.25), (3, 1, 2.25), (3, 2, 1),
                 (7, 2, 1)]


def zoo_batch(seed: int = 7, n: int = ZOO_N, h: int = ZOO_H):
    """A global batch of n images of h rows (the JAX spatial test's H by
    default) and its W, with ignored labels across the middle band
    boundary and at the top."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, ZOO_W, 3)).astype(np.float32)
    y = rng.integers(0, C, (n, h, ZOO_W)).astype(np.int32)
    y[:, :6, :9] = 255
    y[:, 60:70, 20:30] = 255
    return x, y


def halo_input(s: int) -> torch.Tensor:
    """The halo cases' global tensor: 2 images of 16 rows (float64, exact
    sums), R = 16 / S rows a band."""
    rng = np.random.default_rng(40 + s)
    return _t(rng.normal(size=(2, 16, 3, 2)))


def halo_rows_of(case, rows: int) -> tuple[int, int]:
    top, bottom = case
    return int(top * rows), int(bottom * rows)


def case_halos() -> dict:
    """`halo` of the rank's band for each of HALO_CASES, and the band's
    gradient of Σ_ranks (y · c), c drawn for each (case, rank); then
    `on_band` with a conv of each of ON_BAND_CASES (float64): its output
    and the band's gradient of Σ (out · c)."""
    n = distributed.num_spatial()
    x = distributed.band_rows(distributed.shard_rows(halo_input(n)))
    rows = x.shape[1]
    out = {}
    for i, case in enumerate(HALO_CASES):
        xb = x.clone().requires_grad_(True)
        y = distributed.halo(xb, *halo_rows_of(case, rows))
        c = halo_cotangent(i, distributed.rank(), y.shape)
        (y * c).sum().backward()
        out[f"halo{i}"] = {"y": y.detach(), "dx": xb.grad}
    for i, (k, stride, dil) in enumerate(ON_BAND_CASES):
        out[f"on_band{i}"] = on_band_case(x, i, k, stride, dil)
    return out


def halo_cotangent(i: int, rank: int, shape) -> torch.Tensor:
    return _t(np.random.default_rng(1000 * i + rank).normal(size=shape))


def on_band_conv(i: int, k: int, stride: int, dil, rows: int):
    """(fn, top, bottom): a conv of ON_BAND_CASES[i] at band rows `rows`
    (its dilation in band rows for a 3x3, 1 otherwise) with the halo
    `ops.conv.band_halo` gives it."""
    import torch.nn.functional as F
    from torch_semantic_segmentation_tpu_torch.ops.conv import band_halo
    d = max(1, int(dil * rows)) if k == 3 and stride == 1 else 1
    pad = d * (k - 1) // 2
    wt = _t(np.random.default_rng(60 + i).normal(size=(2, 2, k, k)))

    def fn(t):
        y = F.conv2d(t.permute(0, 3, 1, 2), wt, stride=stride, padding=pad,
                     dilation=d)
        return y.permute(0, 2, 3, 1)
    return (fn, *band_halo(k, stride, pad, d))


def on_band_case(x: torch.Tensor, i: int, k: int, stride: int, dil) -> dict:
    fn, top, bottom = on_band_conv(i, k, stride, dil, x.shape[1])
    xb = x.clone().requires_grad_(True)
    y = distributed.on_band(fn, xb, top, bottom, down=stride)
    c = halo_cotangent(100 + i, distributed.rank(), y.shape)
    (y * c).sum().backward()
    return {"y": y.detach(), "dx": xb.grad}


def zoo_model(name: str, init: str | None = None, **kw):
    """A zoo model on the CPU, from `init` where one is given (the JAX
    package's weights) and from seed 0 otherwise."""
    from torch_semantic_segmentation_tpu_torch.models import get_model
    kw = {**(ZOO_UNET if name == "unet" else {}), **kw}
    m = get_model(name, C, device="cpu", **kw)
    if init is not None:
        m.load_state_dict(torch.load(init, weights_only=True))
    return m


ZOO_EVAL = (("deeplab", "deeplabv3_resnet18", {}),
            ("unet_deconv", "unet", {"upsample": "deconv"}),
            ("unet_bilinear", "unet", {"upsample": "bilinear"}))


def case_zoo_eval(outdir: str) -> dict:
    """The eval forward's logits of the rank's band for each model of
    ZOO_EVAL on the JAX package's weights (`<key>.pt`) and the JAX spatial
    test's input; ResNet-50's (the BottleneckBlock path, the port's own
    weights); `evaluate`'s matrix of DeepLab's 1/16 logits (×16 resize +
    argmax) and of UNet's bilinear decoder over two batches."""
    from torch_semantic_segmentation_tpu_torch.data.synthetic import (
        synthetic_batch)
    from torch_semantic_segmentation_tpu_torch.eval import evaluate
    from torch_semantic_segmentation_tpu_torch.train import make_eval_step
    x = synthetic_batch(ZOO_N, ZOO_H, ZOO_W, C, seed=7)[0]
    (xb,) = _bands(x, max_stride=16)
    out = {}
    with torch.no_grad():
        for key, name, kw in ZOO_EVAL:
            m = zoo_model(name, os.path.join(outdir, f"{key}.pt"), **kw)
            out[key] = m.eval()(xb)
        out["deeplab50"] = zoo_model("deeplabv3_resnet50").eval()(xb)
    batches = [_bands(*zoo_batch(seed), max_stride=16) for seed in (8, 9)]
    for key, name, kw in (("deeplab", "deeplabv3_resnet18",
                           {"upsample_logits": False}),
                          ("unet_bilinear", "unet", {"upsample": "bilinear"})):
        m = zoo_model(name, os.path.join(outdir, f"{key}.pt"), **kw)
        step = make_eval_step(m, num_classes=C, device="cpu")
        out[f"cm_{key}"] = evaluate(step, batches, num_classes=C,
                                    device="cpu")[2]
    return out


def suite_zoo(outdir: str) -> dict:
    return {"halos": case_halos(), "eval": case_zoo_eval(outdir)}


def zoo_loss(route: str):
    """(model name, model keywords, loss) of a train-step route: ENet,
    ERFNet and ESNet with CE (ENet's weighing its classes); DeepLab's OHEM on its 1/16 logits in float32 (the exact top-k), with
    its aux head too, in float32 and on bf16 logits (K3's plain version on
    both heads), and on full-resolution logits by bisection; UNet's two
    decoders with CE."""
    import functools
    if route.split("_")[0] in STR_MODELS:
        dtype = torch.bfloat16 if route.endswith("k1") else None
        return (route.split("_")[0], {"upsample_logits": False},
                lambda lg, y: losses.resize_cross_entropy_loss(
                    lg if dtype is None else lg.to(dtype), y))
    if route.split("_")[0] in CAS_MODELS:
        dtype = torch.bfloat16 if route.endswith("k3") else None
        head = losses.SegLoss(
            lambda lg, y: losses.resize_ohem_cross_entropy(
                lg if dtype is None else lg.to(dtype), y, **ZOO_OHEM),
            handles_resize=True)
        return (route.split("_")[0], CAS_KW,
                functools.partial(losses.aux_weighted_loss, loss_fn=head,
                                  aux_weight=1.0))
    if route in DEC_MODELS:
        return (route, {}, functools.partial(
            losses.cross_entropy_loss, class_weights=torch.tensor(
                DEC_CLASS_WEIGHTS)) if route == "enet"
            else losses.cross_entropy_loss)
    if route == "deeplab_exact":
        return ("deeplabv3_resnet18", {"upsample_logits": False},
                functools.partial(losses.resize_ohem_cross_entropy,
                                  **ZOO_OHEM))
    if route.startswith("deeplab_aux"):
        dtype = torch.bfloat16 if route.endswith("k3") else torch.float32
        head = losses.SegLoss(
            lambda lg, y: losses.resize_ohem_cross_entropy(
                lg.to(dtype), y, **ZOO_OHEM), handles_resize=True)
        return ("deeplabv3_resnet18", {"upsample_logits": False, "aux": True},
                functools.partial(losses.aux_weighted_loss, loss_fn=head))
    if route == "deeplab_bisect":
        return ("deeplabv3_resnet18", {},
                functools.partial(losses.ohem_cross_entropy, exact=False,
                                  **ZOO_OHEM))
    return ("unet", {"upsample": route.split("_")[1]},
            losses.cross_entropy_loss)


ZOO_ROUTES = ("deeplab_exact", "deeplab_aux", "deeplab_aux_k3",
              "deeplab_bisect", "unet_deconv", "unet_bilinear")


def nudged_moments():
    """Within the block every train-mode BN's batch mean is one float32
    step up (its gradient unchanged): a sum of the bands' parts in another
    order moves it so, and with it every value near a ReLU's zero or a
    rounding boundary (`chip_smoke.nudged_moments`' yardstick, in this
    process)."""
    import contextlib

    from torch_semantic_segmentation_tpu_torch.ops import conv
    real = conv.batch_moments

    def nudged(x, dims):
        mean, sq = real(x, dims)
        m = mean.detach()
        return mean + (torch.nextafter(m, torch.full_like(m, np.inf))
                       - m), sq

    @contextlib.contextmanager
    def block():
        conv.batch_moments = nudged
        try:
            yield
        finally:
            conv.batch_moments = real
    return block()


def case_zoo_grads(route: str, dtype=torch.float32) -> dict:
    """One train-mode forward and backward of a route (the model from seed
    0, dropout on: the bands draw the single process's masks), its
    parameters and input cast to `dtype`: the global loss, the parameter
    gradients summed over ranks, the BN statistics after it, the K1, K3
    and halo exchanges it made."""
    from torch_semantic_segmentation_tpu_torch.ops import resize_ce
    name, kw, loss_fn = zoo_loss(route)
    m = zoo_model(name, **kw).to(dtype).train()
    x, y = _bands(*zoo_batch(7, ZOO_STEP_N, STR_H.get(name, ZOO_H)),
                  max_stride=m.max_stride)
    x = x.to(dtype)
    calls = {"k1": [], "k3": []}
    real = {k: getattr(resize_ce, f) for k, f in PLAIN_CE.items()}
    for k, f in PLAIN_CE.items():
        setattr(resize_ce, f, lambda *a, k=k: calls[k].append(a[0].shape)
                or real[k](*a))
    h0 = distributed.halo_exchanges
    try:
        share = loss_fn(m(x), y)
        share.backward()
    finally:
        for k, f in PLAIN_CE.items():
            setattr(resize_ce, f, real[k])
    distributed.all_reduce_gradients(m.parameters())
    return {"loss": distributed.reduce_sum(share.detach()),
            "grads": {k: p.grad.clone() for k, p in m.named_parameters()},
            "k1": torch.tensor(len(calls["k1"])),
            "k3": torch.tensor(len(calls["k3"])),
            "halo_exchanges": torch.tensor(distributed.halo_exchanges - h0),
            "stats": {k: v.clone() for k, v in m.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


def case_zoo_steps(route: str, seeds=(7, 10)) -> dict:
    """SGD steps (LR 0.002) of a route through `make_train_step`, one on
    the batch of each of `seeds` (two by default): the losses and the
    state after each."""
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)
    name, kw, loss_fn = zoo_loss(route)
    model = zoo_model(name, **kw)
    state = create_train_state(model, OptimizerConfig(lr=LR, max_steps=4))
    step = make_train_step(model, state, loss_fn, device="cpu")
    out = {"losses": []}
    for i, seed in enumerate(seeds):
        batch = _bands(*zoo_batch(seed, ZOO_STEP_N, STR_H.get(name, ZOO_H)),
                       max_stride=model.max_stride)
        out["losses"].append(step(*batch)["loss"])
        out[f"state{i + 1}"] = {k: v.clone() for k, v in
                                model.state_dict().items()}
    out["losses"] = torch.stack(out["losses"])
    return out


def aspp_inputs():
    """ASPP's global input (4 images of 16 rows, each its own offset, so
    that the image-level branch's 4 values a channel are well apart) and
    the cotangent of its output."""
    rng = np.random.default_rng(50)
    x = rng.normal(size=(ZOO_STEP_N, 16, 6, 16)).astype(np.float32)
    x += 0.5 * np.arange(ZOO_STEP_N, dtype=np.float32)[:, None, None, None]
    return x, rng.normal(size=(ZOO_STEP_N, 16, 6, 8)).astype(np.float32)


def case_aspp() -> dict:
    """ASPP alone in train mode, rates (2, 6, 9) on bands of 4 or 8 rows:
    its output, the band's input gradient and the parameter gradients
    summed over ranks of Σ (y · c), and the image-level branch's BN
    statistics, whose N values a channel are the same on every band of a
    data row (`batch_moments` weighs each rank 1/R)."""
    from torch_semantic_segmentation_tpu_torch.ops import ASPP
    aspp = ASPP(16, 8, rates=(2, 6, 9),
                generator=torch.Generator().manual_seed(5)).train()
    x, c = _bands(*aspp_inputs(), max_stride=4)
    x.requires_grad_(True)
    y = aspp(x)
    (y * c).sum().backward()
    distributed.all_reduce_gradients(aspp.parameters())
    return {"y": y.detach(), "dx": x.grad,
            "grads": {k: p.grad.clone() for k, p in aspp.named_parameters()},
            "stats": {k: v.clone() for k, v in aspp.state_dict().items()
                      if k.startswith("image_pool.bn.running")}}


ZOO_STEP_ROUTES = ("deeplab_exact", "unet_bilinear")
# the plain versions of K1's and K3's forwards, counted as their calls
PLAIN_CE = {"k1": "resize_ce_reference", "k3": "resize_ce_map_reference"}


def suite_zoo_step() -> dict:
    res = {f"grads_{r}": case_zoo_grads(r) for r in ZOO_ROUTES}
    res["aspp"] = case_aspp()
    res.update({f"steps_{r}": case_zoo_steps(r) for r in ZOO_STEP_ROUTES})
    return res


# --- suite "dec:S": ENet, ERFNet and ESNet on H bands (num_spatial=S) ---

DEC_MODELS = ("enet", "erfnet", "esnet")
DEC_STEP_MODELS = ("enet", "erfnet")
# ENet's loss weighs the classes, as BASELINE config 1's does
DEC_CLASS_WEIGHTS = (1.0, 2.5, 0.5, 4.0, 1.5)


def case_dec_eval(outdir: str) -> dict:
    """The eval forward's logits of the rank's band for each of DEC_MODELS
    on the JAX package's weights (`<name>.pt`) and the JAX spatial test's
    input, and `evaluate`'s matrix of each over two batches."""
    from torch_semantic_segmentation_tpu_torch.data.synthetic import (
        synthetic_batch)
    from torch_semantic_segmentation_tpu_torch.eval import evaluate
    from torch_semantic_segmentation_tpu_torch.train import make_eval_step
    x = synthetic_batch(ZOO_N, ZOO_H, ZOO_W, C, seed=7)[0]
    (xb,) = _bands(x, max_stride=8)
    batches = [_bands(*zoo_batch(seed), max_stride=8) for seed in (8, 9)]
    out = {}
    for name in DEC_MODELS:
        m = zoo_model(name, os.path.join(outdir, f"{name}.pt")).eval()
        with torch.no_grad():
            out[name] = m(xb)
        step = make_eval_step(m, num_classes=C, device="cpu")
        out[f"cm_{name}"] = evaluate(step, batches, num_classes=C,
                                     device="cpu")[2]
    return out


def suite_dec(outdir: str) -> dict:
    res = {"eval": case_dec_eval(outdir)}
    for r in DEC_MODELS:
        res[f"grads_{r}"] = case_zoo_grads(r)
        res[f"grads64_{r}"] = case_zoo_grads(r, torch.float64)
    res.update({f"steps_{r}": case_zoo_steps(r, seeds=(7,))
                for r in DEC_STEP_MODELS})
    return res


# --- suite "cas:S": BiSeNet and ICNet on H bands (num_spatial=S) ---

CAS_MODELS = ("bisenet", "icnet")
# both on ResNet-18, at config 5's route: 1/8, 1/8 and 1/16 heads
# (BiSeNet), 1/4, 1/8 and 1/16 (ICNet), each to the OHEM at its own ratio
CAS_KW = {"depth": 18, "upsample_logits": False}
# the float32 OHEM aux route, the same on bf16 logits (each head through
# K3's plain version), in train mode
CAS_ROUTES = ("bisenet", "bisenet_k3", "icnet", "icnet_k3")


def case_cas_eval(outdir: str) -> dict:
    """The eval forward's three heads of the rank's band for each of
    CAS_MODELS on the JAX package's weights (`<name>.pt`, full-resolution
    main head) and the JAX spatial test's input, and `evaluate`'s matrix
    of each over two batches on config 5's route (the low-res main head
    through the ×k resize + argmax)."""
    from torch_semantic_segmentation_tpu_torch.data.synthetic import (
        synthetic_batch)
    from torch_semantic_segmentation_tpu_torch.eval import evaluate
    from torch_semantic_segmentation_tpu_torch.train import make_eval_step
    x = synthetic_batch(ZOO_N, ZOO_H, ZOO_W, C, seed=7)[0]
    (xb,) = _bands(x)
    batches = [_bands(*zoo_batch(seed)) for seed in (8, 9)]
    out = {}
    for name in CAS_MODELS:
        init = os.path.join(outdir, f"{name}.pt")
        m = zoo_model(name, init, depth=18).eval()
        with torch.no_grad():
            out[name] = list(m(xb))
        step = make_eval_step(zoo_model(name, init, **CAS_KW),
                              num_classes=C, device="cpu")
        out[f"cm_{name}"] = evaluate(step, batches, num_classes=C,
                                     device="cpu")[2]
    return out


def digest(tensors: dict) -> torch.Tensor:
    """Each tensor's sum and sum of squares, in float64 by numpy (whose
    order of summation no thread count changes): a rank's copy of what
    every rank holds alike (the gradients summed over ranks, the state
    after a step) equals rank 0's where the digests are equal."""
    flat = [t.detach().double().reshape(-1).numpy() for t in tensors.values()]
    return torch.tensor([np.sum(a) for a in flat]
                        + [np.sum(a * a) for a in flat], dtype=torch.float64)


def suite_cas(outdir: str) -> dict:
    """The cases of "cas:S". Every rank holds the same summed gradients
    and state: rank 0 saves them whole, the others their `digest` (whole,
    each rank's would take 0.5 GB of disk: the two models have about 13M
    parameters each)."""
    res = {"eval": case_cas_eval(outdir)}
    for r in CAS_ROUTES:
        res[f"grads_{r}"] = case_zoo_grads(r)
    for r in CAS_MODELS:
        res[f"grads64_{r}"] = case_zoo_grads(r, torch.float64)
        res[f"steps_{r}"] = case_zoo_steps(r, seeds=(7,))
    if distributed.rank() > 0:
        for key, case in res.items():
            for part in ("grads", "state1"):
                if part in case:
                    case[part] = digest(case[part])
    return res


# --- suite "str:S": LEDNet and ContextNet on H bands (num_spatial=S) ---

STR_MODELS = ("lednet", "contextnet")
# the rows of each model's images: LEDNet's APN reaches 1/64, where 256
# rows leave one row a band on 4 bands (128 would leave none, and
# `shard_batch` refuses it); ContextNet's 1/32 has one row a band at 128
STR_H = {"lednet": 256, "contextnet": 128}
# the eval forward's keywords: ContextNet with its two aux heads
STR_EVAL_KW = {"lednet": {}, "contextnet": {"aux": True}}
# the zoo benches' fused route (1/8 logits to the resize CE) in float32,
# and on bf16 logits through K1's plain version
STR_ROUTES = ("lednet", "lednet_k1", "contextnet", "contextnet_k1")


def case_str_eval(outdir: str) -> dict:
    """The eval forward's logits of the rank's band for each of STR_MODELS
    on the JAX package's weights (`<name>.pt`, full-resolution logits,
    ContextNet's aux heads too) and the JAX spatial test's input at the
    model's rows, and `evaluate`'s matrix of each over two batches on the
    fused route (1/8 logits through the ×8 resize + argmax)."""
    from torch_semantic_segmentation_tpu_torch.data.synthetic import (
        synthetic_batch)
    from torch_semantic_segmentation_tpu_torch.eval import evaluate
    from torch_semantic_segmentation_tpu_torch.train import make_eval_step
    out = {}
    for name in STR_MODELS:
        init = os.path.join(outdir, f"{name}.pt")
        m = zoo_model(name, init, **STR_EVAL_KW[name]).eval()
        x = synthetic_batch(ZOO_N, STR_H[name], ZOO_W, C, seed=7)[0]
        (xb,) = _bands(x, max_stride=m.max_stride)
        with torch.no_grad():
            y = m(xb)
        out[name] = list(y) if isinstance(y, tuple) else [y]
        m = zoo_model(name, init, upsample_logits=False,
                      **STR_EVAL_KW[name])
        batches = [_bands(*zoo_batch(seed, ZOO_N, STR_H[name]),
                          max_stride=m.max_stride) for seed in (8, 9)]
        step = make_eval_step(m, num_classes=C, device="cpu")
        out[f"cm_{name}"] = evaluate(step, batches, num_classes=C,
                                     device="cpu")[2]
    return out


def suite_str(outdir: str) -> dict:
    """The cases of "str:S"; without a group (the single process) also
    the float32 routes with `nudged_moments`, the yardstick of their
    bars."""
    res = {"eval": case_str_eval(outdir)}
    for r in STR_ROUTES:
        res[f"grads_{r}"] = case_zoo_grads(r)
        if not distributed.is_initialized():
            with nudged_moments():
                res[f"nudged_{r}"] = case_zoo_grads(r)
    for r in STR_MODELS:
        res[f"grads64_{r}"] = case_zoo_grads(r, torch.float64)
        res[f"steps_{r}"] = case_zoo_steps(r, seeds=(7,))
    return res


# --- suite "ms:S": the multi-scale (+ flip) eval step on H bands ---

# (key, zoo name, keywords, H): ENet (max_stride 8) on both layouts,
# BiSeNet-R18 (max_stride 32, config 5's 1/8 main head) at 256 rows,
# whose scales split on 2 bands only
# (`tests/test_torch_spatial_multiscale.py`)
MS_MODELS = (("enet", "enet", {}, 128),
             ("bisenet", "bisenet", {"depth": 18, "upsample_logits": False},
              256))


def ms_models(spatial: int) -> list:
    return [m for m in MS_MODELS if spatial < 4 or m[0] == "enet"]


def ms_batch(h: int):
    """A global batch of 2 images of h rows: 8x8 blocks of random colour
    plus noise (so that a model's ids vary in patches, not pixel by
    pixel), random labels with ignored rows across the middle band
    boundary and at the top."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=(ZOO_N, h // 8, ZOO_W // 8, 3))
    x = np.repeat(np.repeat(base, 8, 1), 8, 2)
    x = (x + 0.3 * rng.normal(size=x.shape)).astype(np.float32)
    y = rng.integers(0, C, (ZOO_N, h, ZOO_W)).astype(np.int32)
    y[:, :6] = 255
    y[:, h // 2 - 3:h // 2 + 3, :20] = 255
    return x, y


def case_ms(outdir: str, key: str, name: str, kw: dict, h: int,
            dtype) -> dict:
    """The multi-scale + flip step (scales 0.5 .. 1.75) of `name` on the
    JAX package's weights (`<key>.pt`) and the rank's band of `ms_batch`,
    the model and images in `dtype`: the summed
    probabilities (N, H, C, W) and the ids the step counted, and
    `evaluate`'s matrix over the batch."""
    from torch_semantic_segmentation_tpu_torch import eval as teval
    from torch_semantic_segmentation_tpu_torch import metrics
    from torch_semantic_segmentation_tpu_torch.eval import (
        evaluate, make_multiscale_eval_step)
    m = zoo_model(name, os.path.join(outdir, f"{key}.pt"), **kw).to(dtype)
    x, y = _bands(*ms_batch(h), max_stride=m.max_stride)
    step = make_multiscale_eval_step(m, num_classes=C, device="cpu")
    seen = {}
    real_probs, real_update = teval._summed_probs, metrics.update_confusion_matrix

    def probs(*a):
        seen["probs"] = real_probs(*a)
        return seen["probs"]

    def update(cm, preds, labels, **k):
        seen["ids"] = preds
        return real_update(cm, preds, labels, **k)

    teval._summed_probs, metrics.update_confusion_matrix = probs, update
    try:
        cm = evaluate(step, [(x.to(dtype), y)], num_classes=C,
                      device="cpu")[2]
    finally:
        teval._summed_probs, metrics.update_confusion_matrix = (
            real_probs, real_update)
    return {"probs": seen["probs"], "ids": seen["ids"], "cm": cm}


def suite_ms(outdir: str) -> dict:
    res = {}
    for key, name, kw, h in ms_models(distributed.num_spatial()):
        res[key] = case_ms(outdir, key, name, kw, h, torch.float32)
        res[f"{key}64"] = case_ms(outdir, key, name, kw, h, torch.float64)
    return res


# --- suite "cli": the train CLI with --multihost ---

def cli_flags(store: str | None = None) -> list[str]:
    flags = ["--device", "cpu", "--no-bf16", "--dataset", "synthetic",
             "--model", "fastscnn", "--batch-size", "4", "--crop-size", "64",
             "128", "--lr", "0.002", "--log-every", "1",
             "--schedule-steps", "4"]
    if store is not None:
        flags += ["--multihost", "--dist-init-method", f"file://{store}"]
    return flags


def cli_result(run) -> dict:
    return {"losses": torch.tensor([v for _, v in run.losses],
                                   dtype=torch.float64),
            "steps": torch.tensor([s for s, _ in run.losses]),
            "best_miou": torch.tensor(float("nan") if run.best_miou is None
                                      else run.best_miou,
                                      dtype=torch.float64),
            "state": {k: v.clone()
                      for k, v in run.model.state_dict().items()}}


def suite_cli(store: str, outdir: str) -> dict:
    from torch_semantic_segmentation_tpu_torch.cli.train import main
    flags = cli_flags(store)
    res = {"eval": cli_result(main(flags + [
        "--max-iterations", "4", "--eval-every", "4",
        "--eval-batches", "2"]))}
    writes = []
    real_write = checkpoint.CheckpointManager._write

    def counted(self, payload, pruned):
        writes.append(payload["step"])
        return real_write(self, payload, pruned)

    checkpoint.CheckpointManager._write = counted
    ckpt = os.path.join(outdir, "ckpt")
    main(flags + ["--max-iterations", "2", "--checkpoint-dir", ckpt,
                  "--checkpoint-every", "2"])
    res["resumed"] = cli_result(main(flags + [
        "--max-iterations", "4", "--checkpoint-dir", ckpt,
        "--checkpoint-every", "2", "--resume"]))
    checkpoint.CheckpointManager._write = real_write
    res["writes"] = torch.tensor(writes)
    try:
        main(flags + ["--batch-size", "3", "--max-iterations", "1"])
        res["indivisible"] = ""
    except ValueError as e:
        res["indivisible"] = str(e)
    return res


def launch(suite: str, outdir: str, world: int = 2) -> list:
    """Start the ranks of `suite` in the background; `collect` waits."""
    import subprocess
    os.makedirs(outdir, exist_ok=True)
    store = os.path.join(outdir, "store")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, str(r), str(world),
         store, outdir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def collect(procs: list, outdir: str, timeout: float = 240.0) -> list:
    """Every rank's {case: result}, after each exits; raises with a
    failed rank's output."""
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{out}")
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    suite, rank, world, store, outdir = sys.argv[1:6]
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=world, RANK=rank, LOCAL_RANK=rank)
    # "spatial:S", "zoo:S", "dec:S", "cas:S", "str:S" and "ms:S" split each
    # data row's images over S
    # ranks ("spatial:S:grads" runs the gradient cases only, "zoo:S:step"
    # the zoo's train steps)
    num_spatial = int(suite.split(":")[1]) if ":" in suite else 1
    distributed.initialize("cpu", init_method=f"file://{store}",
                           num_spatial=num_spatial)
    if suite == "parallel":
        res = suite_parallel()
    elif suite == "step":
        res = suite_step(outdir)
    elif suite.startswith("spatial"):
        res = suite_spatial(outdir, grads_only=suite.endswith(":grads"))
    elif suite.startswith("zoo"):
        res = (suite_zoo_step() if suite.endswith(":step")
               else suite_zoo(outdir))
    elif suite.startswith("dec"):
        res = suite_dec(outdir)
    elif suite.startswith("cas"):
        res = suite_cas(outdir)
    elif suite.startswith("str"):
        res = suite_str(outdir)
    elif suite.startswith("ms"):
        res = suite_ms(outdir)
    else:
        res = suite_cli(store, outdir)
    torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
    distributed.barrier()
    distributed.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
