"""Train / evaluate / benchmark CLI of the port (the JAX package's
``main.py``):

    python -m ml_autofocusformermod_torch.main --cfg <yaml> [--eval]
        [--throughput] [--resume CKPT] [--batch-size N] [--epochs N]
        [--blr LR] [--data-path P] [--accumulation-steps N] [--output DIR]
        [--tag T] [--device cuda|cpu] [--opts KEY VALUE ...]

Reads the ImageFolder under ``--data-path`` (``<path>/train`` and
``<path>/val``; synthetic images where a split is absent) and takes
``MODEL.NUM_CLASSES`` from its class folders, builds the model from a
seeded random init, and loads weights in the JAX package's order
(``main.py:169-211``): reference ``.pth`` weights from
``MODEL.AFF.PRETRAINED``, else ``MODEL.PRETRAINED``; then ``--resume``: a
reference ``.pth`` loads the weights only, a checkpoint of the port
(``--resume``, else with ``TRAIN.AUTO_RESUME`` the newest under
``<output>/<model name>/<tag>``) its model, and in training its whole
train state. It then measures throughput on the first validation batch (50
warmup + 30 timed forwards, as the reference always does first).
``--throughput`` stops there; ``--eval`` validates and prints acc@1 /
acc@5 / loss. Otherwise it trains: per epoch the train steps over the
train split (fresh augmentations each epoch), a checkpoint and a
validation; a MaskFiner model follows its upsampling curriculum (the
ratios anneal from 1.0 to the configured ones, quantised to 1/20, applied
at the start of an epoch). Batches reach the device through
``data/prefetch.py``. Runs on ``cuda`` unless ``--device cpu``; with no
GPU it raises.
"""

from __future__ import annotations

import argparse
import copy
import datetime
import json
import os
import sys
import time
from typing import List, Optional

import torch

from . import resolve_device
from .ckpt.io import (auto_resume_helper, load_checkpoint,
                      load_model_weights, save_checkpoint)
from .ckpt.pth_import import load_reference_weights
from .config import get_config
from .data.imagenet import build_loaders
from .data.prefetch import prefetch_to_device
from .models.build import build_model
from .train import curriculum
from .train.optim import scale_base_lr
from .train.trainer import (create_train_state, make_eval_step,
                            make_train_step, throughput)
from .utils.logger import create_logger
from .utils.meters import AverageMeter
from .utils.metrics_log import MetricsLogger


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
    parser.add_argument("--eval", action="store_true",
                        help="Perform evaluation only")
    parser.add_argument("--throughput", action="store_true",
                        help="Test throughput only")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="device to run on (default cuda)")
    return parser.parse_args(argv)


def validate(eval_step, loader, device) -> dict:
    """acc1 / acc5 (percent) and mean CE over the valid rows of
    ``loader``'s batches (JAX ``main.py:242-266``: a batch's padding rows
    count for nothing, a short batch for its rows)."""
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


def load_reference(config, model, resume: Optional[str], log) -> dict:
    """Reference ``.pth`` weights into ``model``, in JAX ``main.py:169-211``
    order: ``MODEL.AFF.PRETRAINED`` or else ``MODEL.PRETRAINED``, then a
    ``.pth`` ``resume`` (weights only; the start epoch stays). strict=False:
    each load is logged as "N missing, M unexpected" and returned by name
    (``pretrained``, ``resume_pth``) with its key lists."""
    loaded = {}
    pretrained = config.MODEL.AFF.PRETRAINED or config.MODEL.PRETRAINED
    if pretrained:
        missing, unexpected = load_reference_weights(pretrained, model)
        log(f"loaded pretrained {pretrained}: {len(missing)} missing, "
            f"{len(unexpected)} unexpected")
        loaded["pretrained"] = {"path": pretrained, "missing": missing,
                                "unexpected": unexpected}
    if resume and resume.endswith(".pth"):
        missing, unexpected = load_reference_weights(resume, model)
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
    metrics_log = MetricsLogger(config.OUTPUT, project="CandidateNet",
                                name=config.MODEL.NAME,
                                config=config.to_dict())
    train_step = make_train_step(config, state, schedule)
    eval_step = make_eval_step(config, model)

    # the curriculum anneals from the configured (final) ratios, read once
    final_ratios = (list(model.final_upsampling_ratios)
                    if curriculum.applies_to(model) else None)
    prev_ratios = None
    cuda = device.type == "cuda"

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
        t0 = time.time()
        t_prev = time.perf_counter()
        # decode, augment and the H2D copy run ahead on two threads
        for idx, batch in enumerate(prefetch_to_device(loader, device)):
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
            peak_memory_bytes=peak))
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
                ema_model = copy.deepcopy(model)
                with torch.no_grad():
                    for k, t in ema_model.state_dict(keep_vars=True).items():
                        if k in state.ema:
                            t.copy_(state.ema[k])
                ema = validate(make_eval_step(config, ema_model), val,
                               device)
                logger.info(f"EMA Accuracy: {ema['acc1']:.2f}% / "
                            f"{ema['acc5']:.2f}%")
                result.update(ema_acc1=ema["acc1"], ema_acc5=ema["acc5"])
    metrics_log.finish()
    logger.info(f"Training time "
                f"{datetime.timedelta(seconds=int(time.time() - start))}")
    result["state_step"] = state.step
    return result


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the CLI; returns ``{"throughput_img_s", ...}`` with acc1 / acc5 /
    loss after ``--eval`` and the training numbers (``train``) otherwise,
    and prints it as a JSON line."""
    args = parse_option(argv)
    config = get_config(args)
    device = resolve_device(args.device)
    # linear LR scaling over the batch (reference main.py:437-449)
    config.defrost()
    scale_base_lr(config, config.DATA.BATCH_SIZE)
    config.freeze()
    training = not (config.EVAL_MODE or config.THROUGHPUT_MODE)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    resume = resume_path(config)
    train_loader, val_loader, num_classes = build_loaders(config)
    if num_classes != config.MODEL.NUM_CLASSES:  # JAX main.py:114-120
        config.defrost()
        config.MODEL.NUM_CLASSES = num_classes
        config.freeze()
    model = build_model(config, device)

    def log(msg: str) -> None:
        print(msg, flush=True)

    # weights, in JAX main.py:169-211 order, before the throughput: in
    # training after the train state is made, so an EMA copy keeps the
    # initial weights, as in JAX
    if training:
        state, schedule = create_train_state(config, model,
                                             max(len(train_loader), 1))
    weights = load_reference(config, model, resume, log)
    start_epoch, max_accuracy = config.TRAIN.START_EPOCH, 0.0
    if resume and not resume.endswith(".pth"):
        if training:
            state, epoch, max_accuracy = load_checkpoint(resume, state)
            start_epoch = epoch + 1
            log(f"=> resumed from {resume} (epoch {epoch})")
        else:
            epoch = load_model_weights(resume, model)
            log(f"=> loaded {resume} (epoch {epoch})")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{config.MODEL.NAME}: {n_params} params, "
        f"{config.TPU.COMPUTE_DTYPE}, batch {config.DATA.BATCH_SIZE}, "
        f"{num_classes} classes")

    batch = next(iter(val_loader))
    fps = throughput(model, batch["image"].to(device).float())
    log(f"throughput averaged with 30 times: {fps:.1f} img/s")
    result = {"throughput_img_s": fps, "num_classes": num_classes,
              "weights": weights}
    if config.THROUGHPUT_MODE:
        print(json.dumps(result), flush=True)
        return result

    if training:
        os.makedirs(config.OUTPUT, exist_ok=True)
        logger = create_logger(config.OUTPUT, 0, config.MODEL.NAME)
        with open(os.path.join(config.OUTPUT, "config.json"), "w") as f:
            json.dump(config.to_dict(), f, indent=2)
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
