"""Evaluate / benchmark CLI of the port (the ``--eval`` and ``--throughput``
modes of the JAX package's ``main.py:102-270``):

    python -m ml_autofocusformermod_torch.main --cfg <yaml> [--eval]
        [--throughput] [--batch-size N] [--data-path P]
        [--device cuda|cpu] [--opts KEY VALUE ...]

Builds the model from a seeded random init, measures throughput on one
validation batch (50 warmup + 30 timed forwards, as the reference always
does before evaluating), then, unless ``--throughput``, validates over the
validation set and prints acc@1 / acc@5 / loss. Runs on ``cuda`` unless
``--device cpu``; with no GPU it raises. Training is a later slice.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import torch

from . import resolve_device
from .config import get_config
from .data.synthetic import build_val_dataset, iterate_batches
from .models.build import build_model
from .train.trainer import make_eval_step, throughput


def parse_option(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        "AutoFocusFormer (PyTorch port) evaluation script")
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE",
                        help="path to config file")
    parser.add_argument("--opts", nargs="+", default=None,
                        help="Modify config options via 'KEY VALUE' pairs")
    parser.add_argument("--batch-size", type=int, help="batch size")
    parser.add_argument("--data-path", type=str, help="path to dataset")
    parser.add_argument("--eval", action="store_true",
                        help="Perform evaluation only")
    parser.add_argument("--throughput", action="store_true",
                        help="Test throughput only")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="device to run on (default cuda)")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the CLI; returns ``{"throughput_img_s", ["acc1", "acc5",
    "loss"]}`` and prints the same as a JSON line."""
    args = parse_option(argv)
    if not (args.eval or args.throughput):
        raise SystemExit("training is not ported yet: pass --eval or "
                         "--throughput (ROADMAP.md queue A item 7)")
    config = get_config(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    model = build_model(config, device)
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

    eval_step = make_eval_step(config, model)
    sums = {"loss_sum": 0.0, "top1": 0, "top5": 0, "count": 0}
    for images, labels in iterate_batches(val, batch_size):
        out = eval_step(images.to(device), labels.to(device))
        for k in sums:
            sums[k] += out[k].item()
    n = max(sums["count"], 1)
    result.update(acc1=100.0 * sums["top1"] / n, acc5=100.0 * sums["top5"] / n,
                  loss=sums["loss_sum"] / n)
    print(f"Accuracy of the network on {sums['count']} images: "
          f"{result['acc1']:.1f}% top-1, {result['acc5']:.1f}% top-5, "
          f"loss {result['loss']:.4f}", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
