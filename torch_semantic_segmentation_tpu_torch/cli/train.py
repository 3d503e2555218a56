"""Training CLI of the port (the JAX package's `cli/train.py`): host loader
→ pinned prefetch → augmentation on the card → forward, backward and the
SGD/poly-LR update, eagerly; the host loop only logs, evaluates and saves.

Usage (the JAX CLI's flags and defaults, plus `--device` and the process
group's `--dist-backend` and `--dist-init-method`):

  python -m torch_semantic_segmentation_tpu_torch.cli.train \
      --model fastscnn --dataset cityscapes --dataset-dir /data/cityscapes \
      --batch-size 16 --crop-size 768 --lr 0.045 --max-iterations 160000 \
      --loss ohem --checkpoint-dir ckpts

Smoke run on the CPU, no data: --device cpu --dataset synthetic
--max-iterations 5

Data parallel, one process a card (`--batch-size` is the global batch):

  torchrun --nproc-per-node 2 -m torch_semantic_segmentation_tpu_torch.cli.train \
      --multihost --dataset synthetic --batch-size 8 --max-iterations 5

(`--device cpu` for two CPU ranks over gloo.) Every rank steps on its
rows of each global batch and takes the single process's steps; rank 0
alone prints the log, writes the TensorBoard scalars and the checkpoints.
"""

from __future__ import annotations

import argparse
import os
import time
import typing as tp

import numpy as np
import torch
from torch import nn

from torch_semantic_segmentation_tpu_torch.train import TrainState


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None,
                   help="JSON config file (configs/*.json, one per contract "
                        "config); explicit flags override its values")
    p.add_argument("--model", default="fastscnn")
    p.add_argument("--dataset", default="cityscapes",
                   choices=["cityscapes", "camvid", "bdd", "mapillary",
                            "synthetic", "shapes"])
    p.add_argument("--dataset-dir", default=None)
    p.add_argument("--batch-size", type=int, default=16,
                   help="global batch (one card: the card's batch; under "
                        "--multihost it must divide by the ranks)")
    p.add_argument("--crop-size", type=int, nargs="+", default=[768],
                   help="train crop (one value = square)")
    p.add_argument("--scale-range", type=float, nargs=2, default=[0.5, 2.0])
    p.add_argument("--lr", type=float, default=0.045)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--poly-power", type=float, default=0.9)
    p.add_argument("--max-iterations", type=int, default=1000)
    p.add_argument("--schedule-steps", type=int, default=None,
                   help="poly-LR decay horizon (defaults to "
                        "--max-iterations). Set it to the TOTAL planned "
                        "steps when a run will stop early and --resume "
                        "later, so the schedule is continuous across the "
                        "restart")
    p.add_argument("--loss", default="ce", choices=["ce", "ohem"])
    p.add_argument("--aux-weight", type=float, default=0.4)
    p.add_argument("--class-weights", action="store_true",
                   help="use ENet-style 1/ln(c+p) class weights")
    p.add_argument("--ohem-min-kept", type=int, default=100_000)
    p.add_argument("--fused-resize-loss", action="store_true",
                   help="build the model with upsample_logits=False and "
                        "fuse the final upsample into the loss (K1 for "
                        "--loss ce, K3 for ohem; aux-head models at mixed "
                        "head resolutions too)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each of the model's segments in the "
                        "backward (torch.utils.checkpoint); saves memory "
                        "at full resolution")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=1000)
    p.add_argument("--eval-every", type=int, default=0,
                   help="run val-split mIoU evaluation every N steps "
                        "(0 = off); tracks the best mIoU and keeps that "
                        "checkpoint in <checkpoint-dir>/best")
    p.add_argument("--eval-batches", type=int, default=None,
                   help="cap the number of val batches per in-training eval")
    p.add_argument("--eval-multi-scale", action="store_true",
                   help="use multi-scale(+flip) inference for the "
                        "in-training --eval-every validation / best-ckpt "
                        "selection")
    p.add_argument("--eval-scales", type=float, nargs="+",
                   default=[0.75, 1.0, 1.25],
                   help="scale set for --eval-multi-scale (narrower than "
                        "the eval CLI's six-scale set to bound validation "
                        "cost)")
    p.add_argument("--resume", action="store_true",
                   help="resume from latest checkpoint in --checkpoint-dir")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--logdir", default=None,
                   help="TensorBoard scalar dir (torch.utils.tensorboard; "
                        "needs the tensorboard package): loss, lr, "
                        "images/sec/chip, val mIoU and per-class IoU")
    p.add_argument("--native-loader", action="store_true",
                   help="use the C++ decode/prefetch loader (native/) "
                        "instead of Python threads")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pretrained", default=None,
                   help="torch .pth checkpoint to import before training")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; raises "
                        "when there is none). Pass cpu for the CPU")
    p.add_argument("--multihost", action="store_true",
                   help="join a torch.distributed process group from "
                        "torchrun's environment (WORLD_SIZE, RANK, "
                        "LOCAL_RANK, MASTER_ADDR, MASTER_PORT): one process "
                        "a card, each decoding and stepping on only its "
                        "slice of every global batch "
                        "(parallel.distributed)")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="with --multihost: the process group's backend "
                        "(default: nccl on the card, gloo on the CPU; gloo "
                        "puts several ranks on one card)")
    p.add_argument("--dist-init-method", default="env://",
                   help="with --multihost: the rendezvous (env:// reads "
                        "MASTER_ADDR and MASTER_PORT; file://<path> needs "
                        "neither)")
    args = p.parse_args(argv)
    if args.config:
        import json
        with open(args.config) as f:
            cfg = json.load(f)
        import sys
        given = argv if argv is not None else sys.argv[1:]
        explicit = {a.split("=")[0].lstrip("-").replace("-", "_")
                    for a in given if a.startswith("--")}
        for k, v in cfg.items():
            if k not in explicit:
                setattr(args, k, v)
    return args


class TrainRun(tp.NamedTuple):
    """What `main` returns: the trained model, its optimizer and schedule,
    the generators a checkpoint holds (the augmentation's, then the model's
    dropout generator where it has one), the steps taken in all, the best
    val mIoU (None without `--eval-every`) and the (step, loss) pairs the
    log read (on every rank; rank 0 prints them)."""
    model: nn.Module
    state: TrainState
    generators: tuple[torch.Generator, ...]
    step: int
    best_miou: float | None
    losses: tuple[tuple[int, float], ...] = ()


def main(argv=None) -> TrainRun:
    args = parse_args(argv)

    # Preemption-safe save hook: a cluster's preemption delivers SIGTERM.
    # The handler goes in before the (slow) build so an early signal is not
    # fatal; the train loop checks the flag each step, forces a checkpoint
    # and exits cleanly so --resume continues from there. Only possible
    # from the main thread (CPython restriction): callers on worker threads
    # get no hook. Every rank installs it; under --multihost the ranks
    # agree on the flag at each log point, where the host waits for the
    # card anyway, so all of them stop after the same step.
    import signal
    import threading

    preempted = {"flag": False}

    def _on_term(signum, frame):
        preempted["flag"] = True

    prev_handler = None
    if threading.current_thread() is threading.main_thread():
        prev_handler = signal.signal(signal.SIGTERM, _on_term)
    try:
        return _run(args, preempted)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)


def _summary_writer(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise RuntimeError(
            "--logdir needs the tensorboard package, which is not "
            f"installed ({e})") from e
    return SummaryWriter(logdir)


def _run(args, preempted) -> TrainRun:
    from torch_semantic_segmentation_tpu_torch.cli.common import (
        build_dataset, build_loss, val_batches)
    from torch_semantic_segmentation_tpu_torch.data.pipeline import (
        train_input_pipeline)
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        AugmentConfig)
    from torch_semantic_segmentation_tpu_torch.device import resolve_device
    from torch_semantic_segmentation_tpu_torch.models import get_model
    from torch_semantic_segmentation_tpu_torch.parallel import (
        distributed, replicate)
    from torch_semantic_segmentation_tpu_torch.train import (
        OptimizerConfig, create_train_state, make_train_step)

    if args.multihost:
        dev = distributed.initialize(args.device, backend=args.dist_backend,
                                     init_method=args.dist_init_method)
        print(f"multihost: process {distributed.rank()}/"
              f"{distributed.world_size()}, 1 local / "
              f"{distributed.world_size()} global devices ({dev}, "
              f"{torch.distributed.get_backend()})", flush=True)
        distributed.local_shard_range(args.batch_size)  # B % R == 0
    else:
        dev = resolve_device(args.device)
    multi = distributed.is_multiprocess()
    is_main = distributed.rank() == 0
    log = print if is_main else (lambda *a, **k: None)
    crop = (args.crop_size[0], args.crop_size[-1])
    bundle = build_dataset(args.dataset, args.dataset_dir, "train",
                           synthetic_size=(max(args.batch_size * 2, 8),
                                           crop[0], crop[1]))
    log(f"devices={distributed.world_size()} "
        f"global_batch={args.batch_size} "
        f"model={args.model} dataset={args.dataset} device={dev}")

    model_kwargs = {}
    if args.fused_resize_loss:
        model_kwargs["upsample_logits"] = False
    model = get_model(args.model, num_classes=bundle.num_classes,
                      compute_dtype=torch.bfloat16 if args.bf16 else None,
                      seed=args.seed, device=dev, **model_kwargs)
    if args.pretrained:
        from torch_semantic_segmentation_tpu_torch.compat.torch_loader import (
            load_torch_checkpoint)
        load_torch_checkpoint(model, args.pretrained)
        log(f"imported torch checkpoint {args.pretrained}")
    replicate(model)

    opt_cfg = OptimizerConfig(
        lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
        power=args.poly_power,
        max_steps=args.schedule_steps or args.max_iterations)
    state = create_train_state(model, opt_cfg)
    loss_fn = build_loss(
        args.loss, ignore_index=bundle.ignore_index,
        aux_weight=args.aux_weight,
        class_weights=bundle.class_weights if args.class_weights else None,
        ohem_min_kept=args.ohem_min_kept,
        fused_resize=args.fused_resize_loss, device=dev)
    step = make_train_step(model, state, loss_fn, remat=args.remat,
                           device=dev)

    aug_cfg = AugmentConfig(
        crop=crop, scale_range=tuple(args.scale_range),
        mean=bundle.mean, std=bundle.std, ignore_index=bundle.ignore_index,
        out_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    data_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    dropout_gen = getattr(model, "dropout_generator", None)
    generators = ((data_gen,) if dropout_gen is None
                  else (data_gen, dropout_gen))

    mgr = None
    start_step = 0
    if args.checkpoint_dir:
        from torch_semantic_segmentation_tpu_torch.checkpoint import (
            CheckpointManager)
        mgr = CheckpointManager(args.checkpoint_dir,
                                save_interval_steps=args.checkpoint_every)
        if args.resume:
            restored = mgr.restore_latest(model, state,
                                          generators=generators)
            if restored is not None:
                start_step = restored
                log(f"resumed from step {start_step}")

    writer = (_summary_writer(args.logdir) if args.logdir and is_main
              else None)

    # one batch per step, so batch-sequence == step: on resume the loader
    # fast-forwards to start_step and the (seed, epoch)-keyed shuffle makes
    # the stream bit-identical to an uninterrupted run (the restored
    # augmentation generator continues its draws the same way); under a
    # process group each rank reads its rows of every batch
    batches = train_input_pipeline(
        bundle.dataset, args.batch_size, aug_cfg, generator=data_gen,
        label_lut=bundle.label_lut, device=dev, prefetch=2,
        native=args.native_loader, seed=args.seed, start_batch=start_step)

    # in-training validation and best-checkpoint selection, every
    # --eval-every steps
    best_miou = float("-inf")
    best_mgr = None
    run_validation = None
    if args.eval_every > 0:
        from torch_semantic_segmentation_tpu_torch.eval import evaluate
        from torch_semantic_segmentation_tpu_torch.train import make_eval_step

        val_bundle = build_dataset(
            args.dataset, args.dataset_dir, "val",
            synthetic_size=(max(args.batch_size * 2, 8), crop[0], crop[1]))
        if args.eval_multi_scale:
            from torch_semantic_segmentation_tpu_torch.eval import (
                make_multiscale_eval_step)
            ev = make_multiscale_eval_step(
                model, num_classes=val_bundle.num_classes,
                scales=tuple(args.eval_scales), flip=True,
                ignore_index=val_bundle.ignore_index, device=dev)
        else:
            ev = make_eval_step(model, num_classes=val_bundle.num_classes,
                                ignore_index=val_bundle.ignore_index,
                                device=dev)
        if args.checkpoint_dir:
            from torch_semantic_segmentation_tpu_torch.checkpoint import (
                CheckpointManager)
            best_mgr = CheckpointManager(
                os.path.join(args.checkpoint_dir, "best"),
                max_to_keep=1, save_interval_steps=1)

        def run_validation():
            batches = val_batches(val_bundle, args.batch_size, device=dev,
                                  max_batches=args.eval_batches,
                                  drop_last=True)
            iou, miou, _ = evaluate(ev, batches,
                                    num_classes=val_bundle.num_classes,
                                    device=dev)
            return np.asarray(iou, np.float64), float(miou)

    t0 = time.perf_counter()
    imgs_done = 0
    loss_val = float("nan")
    losses: list[tuple[int, float]] = []
    it = start_step - 1
    for it in range(start_step, args.max_iterations):
        images, labels = next(batches)
        metrics = step(images, labels)
        imgs_done += args.batch_size
        at_log = ((it + 1) % args.log_every == 0
                  or it + 1 == args.max_iterations)
        if at_log:
            loss_val = float(metrics["loss"])   # device sync point
            losses.append((it + 1, loss_val))
            dt = time.perf_counter() - t0
            img_s = imgs_done / dt
            log(f"it {it + 1}/{args.max_iterations} "
                f"loss {loss_val:.6f} "
                f"img/s {img_s:.1f}")
            if writer is not None:
                writer.add_scalar("train/loss", loss_val, it + 1)
                writer.add_scalar("train/images_per_sec_per_chip", img_s,
                                  it + 1)
                writer.add_scalar("train/lr", opt_cfg.lr * opt_cfg.poly(it),
                                  it + 1)
            t0, imgs_done = time.perf_counter(), 0
        if run_validation is not None and (
                (it + 1) % args.eval_every == 0
                or it + 1 == args.max_iterations):
            iou, miou = run_validation()
            marker = ""
            if miou > best_miou:
                best_miou = miou
                marker = " (best)"
                if best_mgr is not None:
                    best_mgr.save(it + 1, model, state,
                                  generators=generators, force=True)
            # worst classes on the console, the full table as
            # val/iou/<class> TensorBoard scalars
            names = val_bundle.class_names
            worst = np.argsort(iou)[:3]
            worst_str = " ".join(
                f"{names[c]}={100 * iou[c]:.1f}" for c in worst)
            log(f"it {it + 1} val mIoU {100 * miou:.2f}{marker} "
                f"worst: {worst_str}")
            if writer is not None:
                writer.add_scalar("val/miou", miou, it + 1)
                for c in range(len(names)):
                    writer.add_scalar(f"val/iou/{names[c]}", float(iou[c]),
                                      it + 1)
        # capture the flag BEFORE the save so a signal landing mid-save is
        # handled next iteration rather than skipping the forced checkpoint
        stopping = preempted["flag"]
        if multi:
            stopping = at_log and bool(distributed.reduce_max(torch.tensor(
                int(stopping), device=dev)).item())
        if mgr is not None:
            mgr.save(it + 1, model, state, generators=generators,
                     force=(it + 1 == args.max_iterations or stopping))
        if stopping:
            if mgr is not None:
                log(f"SIGTERM: checkpoint saved at it {it + 1}, exiting "
                    "(restart with --resume)")
            else:
                log("SIGTERM: exiting (no --checkpoint-dir, nothing saved)")
            break
    if mgr is not None:
        mgr.close()
    if best_mgr is not None:
        best_mgr.close()
    if writer is not None:
        writer.close()
    if best_miou > float("-inf"):
        log(f"done: final loss {loss_val:.4f} "
            f"best val mIoU {100 * best_miou:.2f}")
    else:
        log(f"done: final loss {loss_val:.4f}")
    return TrainRun(model, state, generators, it + 1,
                    best_miou if best_miou > float("-inf") else None,
                    tuple(losses))


def cli() -> int:
    """Console-script entry point (pyproject [project.scripts]): discard
    main()'s programmatic return value so setuptools' sys.exit() sees 0."""
    main()
    return 0


if __name__ == "__main__":
    main()
