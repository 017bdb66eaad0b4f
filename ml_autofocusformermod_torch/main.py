"""Train / evaluate / benchmark CLI of the port (the JAX package's
``main.py``):

    python -m ml_autofocusformermod_torch.main --cfg <yaml> [--eval]
        [--throughput] [--resume CKPT] [--batch-size N] [--epochs N]
        [--blr LR] [--data-path P] [--accumulation-steps N] [--output DIR]
        [--tag T] [--device cuda|cpu] [--opts KEY VALUE ...]

Builds the model from a seeded random init, loads the checkpoint to
resume from (``--resume``, else with ``TRAIN.AUTO_RESUME`` the newest under
``<output>/<model name>/<tag>``) and measures throughput on one validation
batch (50 warmup + 30 timed forwards, as the reference always does first).
``--throughput`` stops there; ``--eval`` validates and prints acc@1 /
acc@5 / loss. Otherwise it trains: per epoch the train steps over the
(synthetic) train split, a checkpoint and a validation; a MaskFiner model
follows its upsampling curriculum (the ratios anneal from 1.0 to the
configured ones, quantised to 1/20, applied at the start of an epoch).
Reference ``.pth`` weights (``.pth`` resume, ``MODEL.PRETRAINED``,
``MODEL.AFF.PRETRAINED``) are not ported and raise, as does a missing
checkpoint. Runs on ``cuda`` unless ``--device cpu``; with no GPU it
raises.
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
from .config import get_config
from .data.synthetic import (TrainLoader, build_train_dataset,
                             build_val_dataset, iterate_batches)
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


def validate(eval_step, dataset, batch_size: int, device) -> dict:
    """acc1 / acc5 (percent) and mean CE over ``dataset``."""
    sums = {"loss_sum": 0.0, "top1": 0, "top5": 0, "count": 0}
    for images, labels in iterate_batches(dataset, batch_size):
        out = eval_step(images.to(device), labels.to(device))
        for k in sums:
            sums[k] += out[k].item()
    n = max(sums["count"], 1)
    return {"acc1": 100.0 * sums["top1"] / n, "acc5": 100.0 * sums["top5"] / n,
            "loss": sums["loss_sum"] / n, "count": sums["count"]}


def resume_path(config) -> Optional[str]:
    """The checkpoint to start from, as JAX ``main.py:168-211`` picks it:
    ``MODEL.RESUME``, else with ``TRAIN.AUTO_RESUME`` the newest under
    ``OUTPUT``, else None. Raises on what the port cannot load: a
    reference ``.pth``, ``MODEL.PRETRAINED`` or ``MODEL.AFF.PRETRAINED``
    (ROADMAP A8), or a path that does not exist."""
    for key, path in (("MODEL.PRETRAINED", config.MODEL.PRETRAINED),
                      ("MODEL.AFF.PRETRAINED", config.MODEL.AFF.PRETRAINED)):
        if path:
            raise NotImplementedError(
                f"{key} {path!r}: importing reference weights is not ported "
                "yet (ROADMAP.md queue A item 8)")
    resume = config.MODEL.RESUME
    if not resume and config.TRAIN.AUTO_RESUME:
        resume = auto_resume_helper(config.OUTPUT)
    if not resume:
        return None
    if resume.endswith(".pth"):
        raise NotImplementedError(
            f"--resume {resume!r}: importing a reference .pth checkpoint is "
            "not ported yet (ROADMAP.md queue A item 8)")
    if not os.path.isfile(resume):
        raise FileNotFoundError(f"checkpoint to resume from not found: "
                                f"{resume}")
    return resume


def train(config, model, device, val, logger, resume=None) -> dict:
    """The training loop of the JAX package's ``main.py:275-401``: per epoch
    the upsampling curriculum's ratios (MaskFiner), the train steps, a
    checkpoint and a validation. Starts from the checkpoint ``resume``
    when given. Returns the last epoch's numbers."""
    batch_size = config.DATA.BATCH_SIZE
    loader = TrainLoader(build_train_dataset(config), batch_size,
                         seed=config.SEED)
    state, schedule = create_train_state(config, model, max(len(loader), 1))
    start_epoch = config.TRAIN.START_EPOCH
    max_accuracy = 0.0
    if resume:
        state, epoch, max_accuracy = load_checkpoint(resume, state)
        start_epoch = epoch + 1
        logger.info(f"=> resumed from {resume} (epoch {epoch})")
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
        step_seconds, skipped = [], 0
        t0 = time.time()
        for idx, (images, labels) in enumerate(loader):
            images = images.to(device)
            labels = labels.to(device)
            ts = time.perf_counter()
            metrics = train_step(images, labels)
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
        steps = len(step_seconds)
        img_s = steps * batch_size / max(sum(step_seconds), 1e-12)
        img_s_after_first = ((steps - 1) * batch_size / sum(step_seconds[1:])
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
            img_s_after_first=img_s_after_first, step_seconds=step_seconds,
            peak_memory_bytes=peak))
        result.update(epoch=epoch, steps=steps, skipped_steps=skipped,
                      train_loss=meters["loss"].avg,
                      last_loss=meters["loss"].val,
                      last_grad_norm=meters["grad_norm"].val,
                      train_img_s=img_s,
                      train_img_s_after_first=img_s_after_first,
                      step_seconds=step_seconds)
        if epoch % config.SAVE_FREQ == 0 or epoch == config.TRAIN.EPOCHS - 1:
            result["checkpoint"] = save_checkpoint(
                config.OUTPUT, epoch, state, max_accuracy,
                keep_every=config.SAVE_FREQ)
        if epoch % config.EVAL_FREQ == 0 or epoch == config.TRAIN.EPOCHS - 1:
            acc = validate(eval_step, val, batch_size, device)
            max_accuracy = max(max_accuracy, acc["acc1"])
            logger.info(f"Accuracy: {acc['acc1']:.2f}% top-1 / "
                        f"{acc['acc5']:.2f}% top-5 (max {max_accuracy:.2f}%)")
            metrics_log.log({"val/acc1": acc["acc1"], "val/acc5": acc["acc5"],
                             "val/loss": acc["loss"], "epoch": epoch},
                            step=state.step)
            result.update(acc1=acc["acc1"], acc5=acc["acc5"],
                          val_loss=acc["loss"], max_accuracy=max_accuracy)
            if state.ema is not None:
                ema_model = copy.deepcopy(model)
                with torch.no_grad():
                    for k, t in ema_model.state_dict(keep_vars=True).items():
                        if k in state.ema:
                            t.copy_(state.ema[k])
                ema = validate(make_eval_step(config, ema_model), val,
                               batch_size, device)
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
    model = build_model(config, device)
    resume = resume_path(config)
    if resume and not training:
        epoch = load_model_weights(resume, model)
        print(f"=> loaded {resume} (epoch {epoch})", flush=True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{config.MODEL.NAME}: {n_params} params, "
          f"{config.TPU.COMPUTE_DTYPE}, batch {config.DATA.BATCH_SIZE}",
          flush=True)

    val = build_val_dataset(config)
    batch_size = config.DATA.BATCH_SIZE
    images, _ = next(iterate_batches(val, batch_size))
    fps = throughput(model, images.to(device))
    print(f"throughput averaged with 30 times: {fps:.1f} img/s", flush=True)
    result = {"throughput_img_s": fps}
    if config.THROUGHPUT_MODE:
        print(json.dumps(result), flush=True)
        return result

    if training:
        os.makedirs(config.OUTPUT, exist_ok=True)
        logger = create_logger(config.OUTPUT, 0, config.MODEL.NAME)
        with open(os.path.join(config.OUTPUT, "config.json"), "w") as f:
            json.dump(config.to_dict(), f, indent=2)
        result["train"] = train(config, model, device, val, logger, resume)
        print(json.dumps(result), flush=True)
        return result

    acc = validate(make_eval_step(config, model), val, batch_size, device)
    result.update(acc1=acc["acc1"], acc5=acc["acc5"], loss=acc["loss"])
    print(f"Accuracy of the network on {acc['count']} images: "
          f"{result['acc1']:.1f}% top-1, {result['acc5']:.1f}% top-5, "
          f"loss {result['loss']:.4f}", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
