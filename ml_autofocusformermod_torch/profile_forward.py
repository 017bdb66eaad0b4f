"""Device-time breakdown of the AFF forward on one GPU.

    python -m ml_autofocusformermod_torch.profile_forward
        [--cfg FILE] [--batch-size 128] [--iters 5] [--opts KEY VALUE ...]

After 10 warmup forwards, times at least 10 forwards one by one (host clock
around a synchronised forward, no profiler), then traces ``--iters``
forwards with ``torch.profiler``. Prints JSON lines: the unprofiled forward
time, the device time per forward by kernel group (the two fused CUDA
kernels, matmuls, convolutions, sorts, the rest), the top kernels by device
time, and the device's busy and idle share of the traced window (the
profiler's host cost inflates that window). Fails when the profiler records
no device time.
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
from .data.synthetic import build_val_dataset, iterate_batches
from .models.build import build_model

GROUPS = [  # first match wins
    ("cluster_attention_fwd", r"cluster_attention_fwd"),
    ("cluster_merge_fwd", r"cluster_merge_fwd"),
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


def main(argv=None) -> dict:
    here = os.path.dirname(os.path.abspath(__file__))
    parser = argparse.ArgumentParser("AFF forward device-time breakdown")
    parser.add_argument("--cfg", default=os.path.join(here, "configs",
                                                      "aff_mini.yaml"))
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--opts", nargs="+", default=None)
    args = parser.parse_args(argv)
    opts = list(args.opts or []) + ["DATA.BATCH_SIZE", str(args.batch_size),
                                    "DATA.DATA_PATH", "no_dataset"]
    config = load_config(args.cfg, opts=opts)
    model = build_model(config, "cuda")
    images, _ = next(iterate_batches(build_val_dataset(config),
                                     args.batch_size))
    images = images.cuda()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        for _ in range(10):
            model(images)
        torch.cuda.synchronize()
        # unprofiled: the profiler's own host cost inflates the wall time
        walls = []
        for _ in range(max(args.iters, 10)):
            t0 = time.perf_counter()
            model(images)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                model(images)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6

    per_kernel = defaultdict(float)
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.key] += us
    busy_us = sum(per_kernel.values())
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    groups = defaultdict(float)
    for name, us in per_kernel.items():
        groups[_group(name)] += us
    n = args.iters
    result = {
        "model": config.MODEL.NAME, "batch": args.batch_size,
        "dtype": config.TPU.COMPUTE_DTYPE,
        "card": torch.cuda.get_device_name(0),
        "forward_ms_unprofiled": {"median": statistics.median(walls) * 1e3,
                                  "max": max(walls) * 1e3,
                                  "samples": len(walls)},
        "forward_wall_ms": wall_us / n / 1e3,
        "forward_device_busy_ms": busy_us / n / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "groups_ms_per_forward": {k: v / n / 1e3 for k, v in
                                  sorted(groups.items(), key=lambda kv: -kv[1])},
    }
    print(json.dumps(result), flush=True)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:25]
    print(json.dumps({"top_kernels_ms_per_forward":
                      [[k[:120], v / n / 1e3] for k, v in top]}), flush=True)
    return result


if __name__ == "__main__":
    main()
