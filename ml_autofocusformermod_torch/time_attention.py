"""Per-call times of the attention kernels at the AFF-Mini 224 b128 bf16
stage shapes, forward and backward, each with its stage's tile metadata
made beforehand (as the model calls them).

    python3 -m ml_autofocusformermod_torch.time_attention [LABEL]

times this checkout. Run as a file from the root of another checkout,
``python3 <this checkout>/ml_autofocusformermod_torch/time_attention.py
LABEL``, it times that checkout's kernels, so that several variants can be
timed on one card one after another. Prints one JSON line: ms per call (median
of 30 CUDA-event timings) for s1-s3 fwd and bwd, and the card's
``nvidia-smi`` name and power limit.
"""

import json
import os
import statistics
import subprocess
import sys

STAGES = [("s1", 3136, 2, 32), ("s2", 784, 4, 128), ("s3", 196, 8, 256)]
CS, NNC, R, B = 8, 6, 55, 128


def time_ms(fn, iters=30, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(x.elapsed_time(y) for x, y in pairs)


def geometry(gen, n, dev):
    """Stage 1 on the grid (batch-broadcast), later stages clustered and
    kNN'd on a 56 x 56 canvas."""
    import torch

    from ml_autofocusformermod_torch.ops.knn import knn
    from ml_autofocusformermod_torch.ops.sfc import (
        grid_tensors, space_filling_cluster)

    if n == 3136:
        g_pos, _, g_ncc = grid_tensors(56, 56, CS, NNC, dev)
        return g_pos[None].expand(B, n, 2), g_ncc[None].expand(B, n, NNC)
    cells = torch.stack([torch.randperm(3136, generator=gen)[:n]
                         for _ in range(B)])
    pos = torch.stack([cells % 56, cells // 56], -1).float().to(dev)
    pos, mean, _, _, _ = space_filling_cluster(pos, CS, 56, 56)
    pos = pos.contiguous()
    return pos, knn(pos, mean, NNC).contiguous()


def main() -> int:
    sys.path.insert(0, os.getcwd())  # the checkout to time, when run as a file
    import torch

    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_backward, fused_cluster_attention, tile_metadata)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else "."}
    for label, n, h, c in STAGES:
        pos, ncc = geometry(gen, n, dev)
        c_ = c // h

        def rnd(*shape):
            return torch.randn(*shape, generator=gen).to(dev)

        q = (rnd(B, n, c) * c_**-0.5).to(torch.bfloat16)
        kv = rnd(B, n, 2 * c).to(torch.bfloat16)
        g = rnd(B, n, c).to(torch.bfloat16)
        args = [q, kv, ncc, pos, rnd(5, h) * 0.1, rnd(h) * 0.1,
                rnd(c_, h) * 0.5, rnd(h, c_) * 0.5]
        meta = tile_metadata(ncc)
        out[label + "_fwd"] = time_ms(
            lambda: fused_cluster_attention(*args, h, CS, R, meta=meta))
        out[label + "_bwd"] = time_ms(
            lambda: cluster_attention_backward(*args, g, h, CS, R, meta=meta))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
