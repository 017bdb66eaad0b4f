"""Train / evaluate / benchmark CLI of the port (the JAX package's
``main.py``):

    python -m ml_autofocusformermod_torch.main --cfg <yaml> [--eval]
        [--throughput] [--resume CKPT] [--batch-size N] [--epochs N]
        [--blr LR] [--data-path P] [--accumulation-steps N] [--output DIR]
        [--tag T] [--profile DIR] [--device cuda|cuda:N|cpu]
        [--dist-backend nccl|gloo] [--dist-url URL]
        [--opts KEY VALUE ...]

    torchrun --nproc-per-node N -m ml_autofocusformermod_torch.main ...

Reads the ImageFolder under ``--data-path`` (``<path>/train`` and
``<path>/val``; synthetic images where a split is absent) and takes
``MODEL.NUM_CLASSES`` from its class folders, builds the model from a
seeded random init, and loads weights in the JAX package's order
(``main.py:169-211``): reference ``.pth`` weights from
``MODEL.AFF.PRETRAINED``, else ``MODEL.PRETRAINED``; then ``--resume``: a
reference ``.pth`` loads the weights only, a checkpoint of the port
(``--resume``, else with ``TRAIN.AUTO_RESUME`` the newest under
``<output>/<model name>/<tag>``) its model, and in training its whole
train state. With ``PRINT_FLOPS`` it logs the forward's
GFLOPs per image (``utils/flops.py``). It then measures throughput on the
first validation batch (50 warmup + 30 timed forwards, as the reference
always does first).
``--throughput`` stops there; ``--eval`` validates and prints acc@1 /
acc@5 / loss. Otherwise it trains: per epoch the train steps over the
train split (fresh augmentations each epoch), a checkpoint and a
validation; a MaskFiner model follows its upsampling curriculum (the
ratios anneal from 1.0 to the configured ones, quantised to 1/20, applied
at the start of an epoch). Batches reach the device through
``data/prefetch.py``. With ``PROFILE`` (``--profile DIR``) the train
steps ``[PROFILE_START, PROFILE_START + PROFILE_STEPS)`` are traced into
that directory (``utils/profiling.py``). ``TPU.REMAT`` recomputes each
block's forward in the backward. Settings the port cannot honour (a mesh
that does not match the processes, ``TPU.USE_PALLAS: false`` on the card)
raise. Runs on ``cuda`` unless ``--device cpu``; with no GPU it raises.

Under torchrun's environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``)
each process is one rank of ``parallel/mesh.py``'s ``(TPU.MESH_DATA,
TPU.MESH_MODEL, TPU.MESH_SEQ)`` layout, on ``cuda:LOCAL_RANK`` unless
``--device`` names a device (two ranks may share one card with ``--device
cuda:0 --dist-backend gloo``). Each data rank loads its shard of the data,
so the global batch is ``DATA.BATCH_SIZE x data`` and the learning rate is
scaled by it; the model is sharded over the model axis
(``parallel/tp.py``), each stage's tokens over the seq axis (the seq ranks
of a data rank load the same images; ``parallel/__init__.py``) and, with
``TPU.ZERO1``, the moments and EMA over the data axis
(``parallel/zero.py``). Every rank measures its throughput; validation
sums over the data ranks; rank 0 alone writes the checkpoints, the logs,
``config.json`` and the metrics log. The process group ends with the run.
"""

from __future__ import annotations

import argparse
import datetime
import itertools
import json
import os
import sys
import time
from typing import List, Optional

import torch

from . import resolve_device
from .ckpt.io import (auto_resume_helper, full_ema, load_checkpoint,
                      load_model_weights, save_checkpoint)
from .ckpt.pth_import import load_reference_weights
from .config import get_config
from .data.imagenet import build_loaders
from .data.prefetch import prefetch_to_device
from .models.build import build_model, check_switches
from .parallel import comm
from .parallel import mesh as mesh_lib
from .parallel.zero import make_layout
from .train import curriculum
from .train.optim import scale_base_lr
from .train.trainer import (create_train_state, ema_tensors,
                            make_eval_step, make_train_step, throughput)
from .utils.flops import model_complexity
from .utils.logger import create_logger
from .utils.meters import AverageMeter
from .utils.metrics_log import MetricsLogger
from .utils.profiling import StepProfiler, span


def parse_option(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        "AutoFocusFormer (PyTorch port) training and evaluation script")
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE",
                        help="path to config file")
    parser.add_argument("--opts", nargs="+", default=None,
                        help="Modify config options via 'KEY VALUE' pairs")
    parser.add_argument("--batch-size", type=int, help="batch size")
    parser.add_argument("--data-path", type=str, help="path to dataset")
    parser.add_argument("--resume", type=str, help="checkpoint to resume from")
    parser.add_argument("--accumulation-steps", type=int,
                        help="gradient accumulation steps")
    parser.add_argument("--output", default="output", type=str,
                        metavar="PATH", help="root of the output folder")
    parser.add_argument("--tag", type=str, help="tag of experiment")
    parser.add_argument("--blr", type=float, help="base learning rate")
    parser.add_argument("--epochs", type=int, help="epochs")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="trace a few train steps with torch.profiler "
                             "into DIR (Perfetto/TensorBoard format)")
    parser.add_argument("--eval", action="store_true",
                        help="Perform evaluation only")
    parser.add_argument("--throughput", action="store_true",
                        help="Test throughput only")
    parser.add_argument("--device", default="cuda",
                        help="cuda, cuda:N or cpu (default cuda; under "
                             "torchrun cuda:LOCAL_RANK)")
    parser.add_argument("--dist-backend", default=None,
                        choices=("nccl", "gloo"),
                        help="process group backend (default nccl on the "
                             "card, gloo on the CPU)")
    parser.add_argument("--dist-url", default="env://",
                        help="process group rendezvous (default env://, "
                             "torchrun's MASTER_ADDR and MASTER_PORT)")
    return parser.parse_args(argv)


def validate(eval_step, loader, device) -> dict:
    """acc1 / acc5 (percent) and mean CE over the valid rows of
    ``loader``'s batches (JAX ``main.py:242-266``: a batch's padding rows
    count for nothing, a short batch for its rows); under data
    parallelism ``eval_step`` sums over the data ranks, each of which
    iterates its own shard."""
    sums = {"loss_sum": 0.0, "top1": 0, "top5": 0, "count": 0}
    for batch in prefetch_to_device(loader, device):
        out = eval_step(batch["image"].float(), batch["label"],
                        batch.get("valid"))
        for k in sums:
            sums[k] += out[k].item()
    n = max(sums["count"], 1)
    return {"acc1": 100.0 * sums["top1"] / n, "acc5": 100.0 * sums["top5"] / n,
            "loss": sums["loss_sum"] / n, "count": sums["count"]}


def _check_weights_path(key: str, path: str) -> None:
    if path.startswith(("http://", "https://")):
        raise ValueError(f"{key} {path!r} is a URL: the port loads local "
                         "files only; download it and pass its path")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{key}: checkpoint not found: {path}")


def resume_path(config) -> Optional[str]:
    """The checkpoint to resume from, as JAX ``main.py:193-211`` picks it:
    ``MODEL.RESUME``, else with ``TRAIN.AUTO_RESUME`` the newest under
    ``OUTPUT``, else None. Raises before any work on a weights file that
    does not exist (the resume path, ``MODEL.PRETRAINED`` or
    ``MODEL.AFF.PRETRAINED``) or is a URL."""
    for key, path in (("MODEL.AFF.PRETRAINED", config.MODEL.AFF.PRETRAINED),
                      ("MODEL.PRETRAINED", config.MODEL.PRETRAINED)):
        if path:
            _check_weights_path(key, path)
    resume = config.MODEL.RESUME
    if not resume and config.TRAIN.AUTO_RESUME:
        resume = auto_resume_helper(config.OUTPUT)
    if resume:
        _check_weights_path("--resume", resume)
    return resume or None


def load_reference(config, model, resume: Optional[str], log,
                   layout=None) -> dict:
    """Reference ``.pth`` weights into ``model``, in JAX ``main.py:169-211``
    order: ``MODEL.AFF.PRETRAINED`` or else ``MODEL.PRETRAINED``, then a
    ``.pth`` ``resume`` (weights only; the start epoch stays). strict=False:
    each load is logged as "N missing, M unexpected" and returned by name
    (``pretrained``, ``resume_pth``) with its key lists."""
    loaded = {}
    pretrained = config.MODEL.AFF.PRETRAINED or config.MODEL.PRETRAINED
    if pretrained:
        missing, unexpected = load_reference_weights(pretrained, model,
                                                     layout)
        log(f"loaded pretrained {pretrained}: {len(missing)} missing, "
            f"{len(unexpected)} unexpected")
        loaded["pretrained"] = {"path": pretrained, "missing": missing,
                                "unexpected": unexpected}
    if resume and resume.endswith(".pth"):
        missing, unexpected = load_reference_weights(resume, model, layout)
        log(f"=> loaded torch checkpoint {resume} ({len(missing)} missing / "
            f"{len(unexpected)} unexpected)")
        loaded["resume_pth"] = {"path": resume, "missing": missing,
                                "unexpected": unexpected}
    return loaded


def train(config, state, schedule, device, loader, val, logger,
          start_epoch: int, max_accuracy: float) -> dict:
    """The training loop of the JAX package's ``main.py:275-401`` over
    ``state`` (made and loaded by :func:`main`): per epoch the upsampling
    curriculum's ratios (MaskFiner), the train steps over ``loader``, a
    checkpoint and a validation over ``val``. Returns the last epoch's
    numbers."""
    batch_size = config.DATA.BATCH_SIZE
    model = state.model
    rank0 = state.layout is None or state.layout.mesh.rank == 0
    metrics_log = MetricsLogger(config.OUTPUT, project="CandidateNet",
                                name=config.MODEL.NAME,
                                config=config.to_dict(), enabled=rank0)
    train_step = make_train_step(config, state, schedule)
    eval_step = make_eval_step(config, model)

    # the curriculum anneals from the configured (final) ratios, read once
    final_ratios = (list(model.final_upsampling_ratios)
                    if curriculum.applies_to(model) else None)
    prev_ratios = None
    cuda = device.type == "cuda"
    profiler = StepProfiler(config.PROFILE, start=config.PROFILE_START,
                            count=config.PROFILE_STEPS)
    if config.PROFILE:
        logger.info(f"profiler: tracing steps [{config.PROFILE_START}, "
                    f"{config.PROFILE_START + config.PROFILE_STEPS}) to "
                    f"{config.PROFILE}")

    logger.info("Start training")
    start = time.time()
    result = {"start_epoch": start_epoch, "epochs": []}
    for epoch in range(start_epoch, config.TRAIN.EPOCHS):
        if final_ratios is not None:
            # JAX main.py:302-323: new ratios rebuild the steps; the port
            # sets them on the live backbones, so parameters, BatchNorm
            # statistics and the optimizer's state carry over
            ratios = curriculum.epoch_upsample_ratios(
                final_ratios, config.TRAIN.EPOCHS, epoch)
            if ratios != prev_ratios:
                logger.info(f"Upsampling ratios now {ratios}")
                curriculum.set_upsample_ratios(model, ratios)
                train_step = make_train_step(config, state, schedule)
                eval_step = make_eval_step(config, model)
                prev_ratios = ratios
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        loader.set_epoch(epoch)
        meters = {k: AverageMeter() for k in ("loss", "grad_norm")}
        step_seconds, wait_seconds, skipped = [], [], 0
        comm_calls, comm_seconds = comm.STATS["calls"], comm.STATS["seconds"]
        t0 = time.time()
        t_prev = time.perf_counter()
        # decode, augment and the H2D copy run ahead on two threads
        batches = prefetch_to_device(loader, device)
        for idx in itertools.count():
            profiler.step(state.step)
            with span("data.wait"):
                batch = next(batches, None)
            if batch is None:
                break
            ts = time.perf_counter()
            wait_seconds.append(ts - t_prev)  # waiting for this batch
            # .float(): a DATA.TRANSPORT_DTYPE float16 batch
            metrics = train_step(batch["image"].float(), batch["label"])
            loss = metrics["loss"].item()  # waits for the step
            step_seconds.append(time.perf_counter() - ts)
            meters["loss"].update(loss)
            meters["grad_norm"].update(metrics["grad_norm"].item())
            if not metrics["grads_finite"]:
                skipped += 1
                logger.warning(f"non-finite gradients at step {idx}")
            if idx % config.PRINT_FREQ == 0:
                logger.info(
                    f"Train: [{epoch}/{config.TRAIN.EPOCHS}][{idx}/"
                    f"{len(loader)}] lr {metrics['lr']:.6f} "
                    f"loss {meters['loss'].val:.4f} ({meters['loss'].avg:.4f}) "
                    f"grad_norm {meters['grad_norm'].val:.4f}")
                metrics_log.log({"train/loss": meters["loss"].val,
                                 "train/grad_norm": meters["grad_norm"].val,
                                 "train/lr": metrics["lr"]}, step=state.step)
            t_prev = time.perf_counter()
        steps = len(step_seconds)
        img_s = steps * batch_size / max(sum(step_seconds), 1e-12)
        img_s_after_first = ((steps - 1) * batch_size / sum(step_seconds[1:])
                             if steps > 1 else None)
        # the same with the waits for the data feed counted
        wall_img_s_after_first = (
            (steps - 1) * batch_size
            / (sum(step_seconds[1:]) + sum(wait_seconds[1:]))
            if steps > 1 else None)
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        logger.info(
            f"EPOCH {epoch} training takes "
            f"{datetime.timedelta(seconds=int(time.time() - t0))}; "
            f"{img_s:.1f} img/s over {steps} steps"
            + (f"; peak memory {peak} bytes" if cuda else ""))
        result["epochs"].append(dict(
            epoch=epoch, ratios=prev_ratios, steps=steps,
            skipped_steps=skipped, img_s=img_s,
            img_s_after_first=img_s_after_first,
            wall_img_s_after_first=wall_img_s_after_first,
            step_seconds=step_seconds, data_wait_seconds=wait_seconds,
            peak_memory_bytes=peak,
            # the collectives of the epoch's steps (parallel/comm.py::STATS)
            collective_calls=comm.STATS["calls"] - comm_calls,
            collective_seconds=comm.STATS["seconds"] - comm_seconds))
        result.update(epoch=epoch, steps=steps, skipped_steps=skipped,
                      train_loss=meters["loss"].avg,
                      last_loss=meters["loss"].val,
                      last_grad_norm=meters["grad_norm"].val,
                      train_img_s=img_s,
                      train_img_s_after_first=img_s_after_first,
                      train_wall_img_s_after_first=wall_img_s_after_first,
                      step_seconds=step_seconds)
        if epoch % config.SAVE_FREQ == 0 or epoch == config.TRAIN.EPOCHS - 1:
            result["checkpoint"] = save_checkpoint(
                config.OUTPUT, epoch, state, max_accuracy,
                keep_every=config.SAVE_FREQ)
        if epoch % config.EVAL_FREQ == 0 or epoch == config.TRAIN.EPOCHS - 1:
            acc = validate(eval_step, val, device)
            max_accuracy = max(max_accuracy, acc["acc1"])
            logger.info(f"Accuracy: {acc['acc1']:.2f}% top-1 / "
                        f"{acc['acc5']:.2f}% top-5 (max {max_accuracy:.2f}%)")
            metrics_log.log({"val/acc1": acc["acc1"], "val/acc5": acc["acc5"],
                             "val/loss": acc["loss"], "epoch": epoch},
                            step=state.step)
            result.update(acc1=acc["acc1"], acc5=acc["acc5"],
                          val_loss=acc["loss"], val_count=acc["count"],
                          max_accuracy=max_accuracy)
            if state.ema is not None:
                # the EMA weights in the model for one validation, then the
                # model's own back (a copy of a sharded model would share
                # its process groups)
                live = {k: t.detach().clone()
                        for k, t in ema_tensors(model).items()}
                shadow = full_ema(state)
                with torch.no_grad():
                    for k, t in ema_tensors(model).items():
                        t.copy_(shadow[k])
                ema = validate(make_eval_step(config, model), val, device)
                with torch.no_grad():
                    for k, t in ema_tensors(model).items():
                        t.copy_(live[k])
                logger.info(f"EMA Accuracy: {ema['acc1']:.2f}% / "
                            f"{ema['acc5']:.2f}%")
                result.update(ema_acc1=ema["acc1"], ema_acc5=ema["acc5"])
    profiler.stop()
    result["profile"] = profiler.path
    metrics_log.finish()
    logger.info(f"Training time "
                f"{datetime.timedelta(seconds=int(time.time() - start))}")
    result["state_step"] = state.step
    return result


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the CLI; returns ``{"throughput_img_s", ...}`` with acc1 / acc5 /
    loss after ``--eval`` and the training numbers (``train``) otherwise,
    and prints it as a JSON line (every rank its own)."""
    args = parse_option(argv)
    config = get_config(args)
    rank, world, local_rank = mesh_lib.init_distributed(
        args.device, args.dist_backend, args.dist_url)
    try:
        return _run(args, config, rank, world, local_rank)
    finally:
        mesh_lib.destroy()


def _run(args, config, rank: int, world: int, local_rank: int) -> dict:
    device = resolve_device(f"cuda:{local_rank}" if args.device == "cuda"
                            and world > 1 else args.device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    check_switches(config, device, world)
    mesh = mesh_lib.make_mesh(int(config.TPU.MESH_DATA),
                              int(config.TPU.MESH_MODEL),
                              int(config.TPU.MESH_SEQ))
    # linear LR scaling over the global batch (reference main.py:437-449,
    # JAX main.py:78-86)
    config.defrost()
    scale_base_lr(config, config.DATA.BATCH_SIZE * mesh.data)
    config.freeze()
    training = not (config.EVAL_MODE or config.THROUGHPUT_MODE)

    def log(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    if device.type == "cuda":
        log(f"device: {torch.cuda.get_device_name(device)}")
    if world > 1:
        seq = f" x seq {mesh.seq}" if mesh.seq > 1 else ""
        log(f"mesh: data {mesh.data} x model {mesh.model}{seq} over {world} "
            f"processes ({torch.distributed.get_backend()}); global batch "
            f"{config.DATA.BATCH_SIZE * mesh.data}")
    resume = resume_path(config)
    train_loader, val_loader, num_classes = build_loaders(
        config, host=mesh.data_rank, num_hosts=mesh.data)
    if num_classes != config.MODEL.NUM_CLASSES:  # JAX main.py:114-120
        config.defrost()
        config.MODEL.NUM_CLASSES = num_classes
        config.freeze()
    model = build_model(config, device)
    n_params = sum(p.numel() for p in model.parameters())
    cost = None
    if config.PRINT_FLOPS:
        # JAX main.py:135-155, on the whole model before the layout (and
        # its mesh) is made; a count that fails fails the run
        cost = model_complexity(model, config.DATA.IMG_SIZE)
        log(f"number of GFLOPs: {cost['flops'] / 1e9:.2f} "
            f"(torch FlopCounterMode, fwd per image)")
        if cost["peak_bytes"] == cost["peak_bytes"]:  # not NaN
            log(f"fwd peak device memory: "
                f"{cost['peak_bytes'] / 2**20:.1f} MiB")
    # the tensor-parallel and ZeRO-1 layout (JAX main.py:213-224); it
    # installs the mesh that the model's batch-wide reductions read
    layout = (make_layout(model, mesh, bool(config.TPU.ZERO1))
              if world > 1 else None)

    # weights, in JAX main.py:169-211 order, before the throughput: in
    # training after the train state is made, so an EMA copy keeps the
    # initial weights, as in JAX
    if training:
        state, schedule = create_train_state(config, model,
                                             max(len(train_loader), 1),
                                             layout=layout)
    weights = load_reference(config, model, resume, log, layout)
    start_epoch, max_accuracy = config.TRAIN.START_EPOCH, 0.0
    if resume and not resume.endswith(".pth"):
        if training:
            state, epoch, max_accuracy = load_checkpoint(resume, state)
            start_epoch = epoch + 1
            log(f"=> resumed from {resume} (epoch {epoch})")
        else:
            epoch = load_model_weights(resume, model, layout)
            log(f"=> loaded {resume} (epoch {epoch})")
    log(f"{config.MODEL.NAME}: {n_params} params, "
        f"{config.TPU.COMPUTE_DTYPE}, batch {config.DATA.BATCH_SIZE}, "
        f"{num_classes} classes")

    batch = next(iter(val_loader))
    fps = throughput(model, batch["image"].to(device).float())
    log(f"throughput averaged with 30 times: {fps:.1f} img/s")
    result = {"throughput_img_s": fps, "num_classes": num_classes,
              "weights": weights, "complexity": cost, "rank": rank,
              "world": world, "data": mesh.data, "model": mesh.model,
              "seq": mesh.seq,
              "backend": (torch.distributed.get_backend()
                          if torch.distributed.is_initialized() else None)}
    if config.THROUGHPUT_MODE:
        print(json.dumps(result), flush=True)
        return result

    if training:
        if rank == 0:
            os.makedirs(config.OUTPUT, exist_ok=True)
            with open(os.path.join(config.OUTPUT, "config.json"), "w") as f:
                json.dump(config.to_dict(), f, indent=2)
        # the log file and the console on rank 0 only
        logger = create_logger(config.OUTPUT if rank == 0 else "", rank,
                               config.MODEL.NAME)
        result["train"] = train(config, state, schedule, device,
                                train_loader, val_loader, logger,
                                start_epoch, max_accuracy)
    else:
        acc = validate(make_eval_step(config, model), val_loader, device)
        result.update(acc1=acc["acc1"], acc5=acc["acc5"], loss=acc["loss"],
                      val_count=acc["count"])
        log(f"Accuracy of the network on {acc['count']} images: "
            f"{result['acc1']:.1f}% top-1, {result['acc5']:.1f}% top-5, "
            f"loss {result['loss']:.4f}")
    result["decoded"] = {"train": dict(train_loader.decode_counts),
                         "val": dict(val_loader.decode_counts)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
