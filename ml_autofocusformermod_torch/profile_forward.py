"""Device-time breakdown of a model's forward (AFF, or a MaskFiner preset
given by ``--cfg``), or of a train step, on one GPU.

    python -m ml_autofocusformermod_torch.profile_forward
        [--cfg FILE] [--batch-size 128] [--iters 5] [--train]
        [--opts KEY VALUE ...]

After 10 warmup passes, times at least 10 passes one by one (host clock
around a synchronised pass, no profiler), then traces ``--iters`` passes
with ``torch.profiler``. A pass is a forward, or with ``--train`` a whole
train step of ``train/trainer.py`` (forward, backward, optimizer); then the
step is also split into its forward, backward and optimizer parts, timed
with a synchronise between them. Prints JSON lines: the unprofiled pass
time, the device time per pass by kernel group (the fused CUDA kernels,
matmuls, convolutions, sorts, the rest), the kernel launches per pass, the
top kernels by device time, and the device's busy and idle share of the
traced window (the profiler's host cost inflates that window). Fails when
the profiler records no device time.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import time
from collections import defaultdict

import torch

from .config import load_config
from .data.imagenet import Loader, build_dataset
from .models.build import build_model
from .train.losses import smooth_one_hot
from .train.trainer import (apply_gradients, create_train_state,
                            make_train_step, model_loss)

GROUPS = [  # first match wins
    ("cluster_attention_fwd", r"cluster_attention_fwd"),
    ("cluster_attention_bwd", r"cluster_attention_bwd"),
    ("cluster_merge_fwd", r"cluster_merge_fwd"),
    ("cluster_merge_bwd", r"cluster_merge_bwd"),
    ("matmul", r"gemm|gemv|cutlass|xmma|cublas|sm90_|matmul"),
    ("conv", r"conv|cudnn|implicit"),
    ("sort_topk", r"sort|radix|topk"),
    ("gather_index", r"gather|index|scatter"),
    ("reduce_norm", r"reduce|norm|softmax"),
]


def _group(name: str) -> str:
    for label, pat in GROUPS:
        if re.search(pat, name, re.IGNORECASE):
            return label
    return "elementwise_other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _train_split(config, state, images, labels, steps: int = 5) -> dict:
    """Median ms of a train step's forward (with the loss), backward and
    optimizer part, each ended by a synchronise."""
    model = state.model
    params = dict(model.named_parameters())
    accum = max(config.TRAIN.ACCUMULATION_STEPS, 1)
    parts = defaultdict(list)
    for _ in range(steps):
        model.train()
        target = smooth_one_hot(labels, config.MODEL.NUM_CLASSES,
                                config.MODEL.LABEL_SMOOTHING)
        for p in params.values():
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model_loss(model(images), target)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        apply_gradients(state, grads, accum, config.TRAIN.EMA_DECAY)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, a, b in (("forward", t0, t1), ("backward", t1, t2),
                        ("optimizer", t2, t3)):
            parts[k].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def main(argv=None) -> dict:
    here = os.path.dirname(os.path.abspath(__file__))
    parser = argparse.ArgumentParser("device-time breakdown of a forward")
    parser.add_argument("--cfg", default=os.path.join(here, "configs",
                                                      "aff_mini.yaml"))
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--train", action="store_true",
                        help="profile train steps instead of forwards")
    parser.add_argument("--opts", nargs="+", default=None)
    args = parser.parse_args(argv)
    opts = list(args.opts or []) + ["DATA.BATCH_SIZE", str(args.batch_size),
                                    "DATA.DATA_PATH", "no_dataset"]
    config = load_config(args.cfg, opts=opts)
    model = build_model(config, "cuda")
    val, _ = build_dataset(config, is_train=False)  # synthetic
    batch = next(iter(Loader(val, args.batch_size, shuffle=False,
                             drop_last=False, stride_shard=True)))
    images, labels = batch["image"].cuda(), batch["label"].cuda()
    split = None
    if args.train:
        state, schedule = create_train_state(config, model, 1000)
        train_step = make_train_step(config, state, schedule)

        def one_pass():
            train_step(images, labels)
    else:
        def one_pass():
            with torch.no_grad():
                model(images)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(10):
        one_pass()
    torch.cuda.synchronize()
    # unprofiled: the profiler's own host cost inflates the wall time
    walls = []
    for _ in range(max(args.iters, 10)):
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if args.train:
        split = _train_split(config, state, images, labels)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            one_pass()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    per_kernel = defaultdict(float)
    launches = 0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.key] += us
            launches += evt.count
    busy_us = sum(per_kernel.values())
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    groups = defaultdict(float)
    for name, us in per_kernel.items():
        groups[_group(name)] += us
    n = args.iters
    what = "step" if args.train else "forward"
    result = {
        "model": config.MODEL.NAME, "batch": args.batch_size,
        "dtype": config.TPU.COMPUTE_DTYPE, "pass": what,
        "card": torch.cuda.get_device_name(0),
        f"{what}_ms_unprofiled": {"median": statistics.median(walls) * 1e3,
                                  "max": max(walls) * 1e3,
                                  "samples": len(walls)},
        f"{what}_wall_ms": wall_us / n / 1e3,
        f"{what}_device_busy_ms": busy_us / n / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
        f"device_ops_per_{what}": launches / n,
        f"groups_ms_per_{what}": {k: v / n / 1e3 for k, v in
                                  sorted(groups.items(), key=lambda kv: -kv[1])},
        "cluster_attention_fwd_share_of_busy":
            groups.get("cluster_attention_fwd", 0.0) / busy_us,
    }
    if split is not None:
        result["step_split_ms_synchronised"] = split
    print(json.dumps(result), flush=True)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:25]
    print(json.dumps({f"top_kernels_ms_per_{what}":
                      [[k[:120], v / n / 1e3] for k, v in top]}), flush=True)
    return result


if __name__ == "__main__":
    main()
