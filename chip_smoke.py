"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, one JSON line each:

1. device: the card (``nvidia-smi`` name and power limit), torch, CUDA and
   nvcc versions;
2. build: every CUDA kernel of ``ml_autofocusformermod_torch/csrc``, built
   from source with nvcc (one process per source, all at once);
3. kernel_check: each kernel against its plain PyTorch version at every
   AFF-Mini 224 shape of the forward (attention at stages 1-3, merges 1-3),
   b = 8, fp32 (max abs <= 1e-4 * max|ref|) and bf16 (plain version in f32
   on the same bf16 inputs, max abs <= 2e-2 * max|ref|); then, at b = 128
   bf16, the shapes of the throughput run, the same bf16 check and the
   kernel's and the plain version's median time (CUDA events) beside the
   least time the card could take;
4. model_check: AFF-Mini 224 built through ``build_model`` and the port's
   ``aff_mini.yaml`` from a fixed seed, fp32, b = 2: the GPU forward (CUDA
   kernels, TF32 off) against the CPU forward (plain versions) on the same
   weights, logits within 1e-3 and the same argmax; 10 attention and 3
   merge launches per forward;
5. eval / throughput: the entry point ``ml_autofocusformermod_torch.main``
   with ``--eval`` over a few synthetic batches, then ``--throughput`` at
   b = 128 in bf16 (50 warmup + 30 timed forwards). The launch counters are
   zeroed just before each run and read just after.

Then the ``kernels`` line, the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``. Any failure raises: the exit code
is non-zero and no result line is printed. Without a GPU, or without the
rest of the repository beside it, the script fails.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # non-tensor f32; bf16 TC
V100_AFF_MINI_IMG_S = 1337.0  # reference AFF-Mini forward, one V100
ATTN_SRC = "ml_autofocusformermod_torch/csrc/cluster_attention.cu"
MERGE_SRC = "ml_autofocusformermod_torch/csrc/cluster_merge.cu"
TPU_ATTN = "ml_autofocusformermod_tpu/ops/clusten_pallas.py:740"
TPU_ATTN_STACKED = "ml_autofocusformermod_tpu/ops/clusten_pallas.py:965"
TPU_MERGE = "ml_autofocusformermod_tpu/ops/merge_pallas.py:199"

# AFF-Mini 224: (tokens, heads, channels) of the local stages and the
# attention launches per forward (= depth); merges: (n, n', c)
ATTN_STAGES = [("stage1", 3136, 2, 32, 2), ("stage2", 784, 4, 128, 2),
               ("stage3", 196, 8, 256, 6)]
MERGES = [("merge1", 3136, 784, 32), ("merge2", 784, 196, 128),
          ("merge3", 196, 49, 256)]
CS, NNC, IC = 8, 6, 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of ``fn``, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    """(least time in ms, what bounds it) for moving ``nbytes`` once and
    doing ``flops`` at the card's peak for the dtype."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    """Bytes of each tensor's distinct storage (a batch-broadcast tensor
    counts once)."""
    total = 0
    for t in tensors:
        shape = [1 if st == 0 else s for s, st in zip(t.shape, t.stride())]
        n = 1
        for s in shape:
            n *= s
        total += n * t.element_size()
    return total


# ------------------------------------------------------------- inputs ----

def clustered_stage(torch, gen, b, n, hw, dev):
    """Positions of a later stage (distinct cells of an hw x hw canvas),
    clustered and kNN'd by the port: (pos (b,n,2), ncc (b,n,nnc) int32)."""
    from ml_autofocusformermod_torch.ops.knn import knn
    from ml_autofocusformermod_torch.ops.sfc import space_filling_cluster

    cells = torch.stack([torch.randperm(hw * hw, generator=gen)[:n]
                         for _ in range(b)])
    pos = torch.stack([cells % hw, cells // hw], -1).float().to(dev)
    pos, mean, _, _, _ = space_filling_cluster(pos, CS, hw, hw)
    return pos.contiguous(), knn(pos, mean, NNC).contiguous()


def stage_geometry(torch, gen, b, n, dev):
    from ml_autofocusformermod_torch.ops.sfc import grid_tensors

    if n == 3136:  # on-grid stage 1: host constants, batch-broadcast
        g_pos, _, g_ncc = grid_tensors(56, 56, CS, NNC, dev)
        return g_pos[None].expand(b, n, 2), g_ncc[None].expand(b, n, NNC)
    return clustered_stage(torch, gen, b, n, 56, dev)


def attention_inputs(torch, gen, b, n, h, c, dev, dtype):
    pos, ncc = stage_geometry(torch, gen, b, n, dev)
    c_ = c // h

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    return dict(
        q=rnd(b, n, c, scale=c_**-0.5).to(dtype),
        kv=rnd(b, n, 2 * c).to(dtype), ncc=ncc, pos=pos,
        pe_kernel=rnd(5, h, scale=0.1), pe_bias=rnd(h, scale=0.1),
        blank_k=rnd(c_, h, scale=0.5), blank_v=rnd(h, c_, scale=0.5),
    )


def merge_inputs(torch, gen, b, n, n_, c, dev, dtype):
    _, ncc = stage_geometry(torch, gen, b, n, dev)
    centres = torch.stack([torch.randperm(n, generator=gen)[:n_]
                           for _ in range(b)]).to(dev)
    sel = torch.gather(ncc, 1, centres[..., None].expand(b, n_, NNC))
    w = torch.randn(b, n_, NNC * CS, IC, generator=gen).to(dev, dtype)
    feat = torch.randn(b, n, c, generator=gen).to(dev, dtype)
    return w, feat, sel.contiguous()


def attn_work(torch, args, h, cs):
    """(bytes, flops) one attention call needs: inputs read once, output
    written once; flops over the slots that hold a token."""
    from ml_autofocusformermod_torch.ops.cluster_gather import (
        cluster_token_index,
    )

    q, ncc = args["q"], args["ncc"]
    b, n, c = q.shape
    c_ = c // h
    valid = (cluster_token_index(ncc, cs) < n).sum().item()  # over b, n, m
    moved = nbytes(*args.values()) + nbytes(q)  # + the output
    flops = valid * h * (4 * c_ + 12) + b * n * h * (2 * c_ + 2 * c_)
    return moved, flops


def merge_work(torch, w, feat, ncc, cs):
    from ml_autofocusformermod_torch.ops.cluster_gather import (
        cluster_token_index,
    )

    b, n_, _, ic = w.shape
    n, c = feat.shape[1], feat.shape[2]
    valid = (cluster_token_index(ncc, cs) < n).sum().item()
    out_bytes = b * n_ * ic * c * w.element_size()
    return nbytes(w, feat, ncc) + out_bytes, valid * ic * c * 2


# ------------------------------------------------------------- phases ----

def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False: "
                         "this script needs an NVIDIA GPU")
    smi = smi_name_power()
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: the kernels target sm_90a, this card "
                         f"is sm_{cap[0]}{cap[1]}")
    from ml_autofocusformermod_torch.ops import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "capability": list(cap),
          "nvcc": nvcc.strip().splitlines()[-1],
          "python": sys.version.split()[0]})
    return smi


def phase_build():
    from ml_autofocusformermod_torch.ops import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source": {k: {"seconds": v["seconds"], "cached": v["cached"],
                             "ptxas": [ln.strip() for ln in v["log"].splitlines()
                                       if "registers" in ln or "spill" in ln]}
                         for k, v in info.items()}})


def check(name, dtype_name, out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = (1e-4 if dtype_name == "float32" else 2e-2) * scale
    ok = err <= tol and bool(out.float().isfinite().all())
    emit({"phase": "kernel_check", "shape": name, "dtype": dtype_name,
          "max_abs_err": err, "max_abs_ref": scale, "tol": tol, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} {dtype_name}: max abs err {err} > {tol}")
    return err


def phase_kernels(torch):
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_reference, fused_cluster_attention,
    )
    from ml_autofocusformermod_torch.ops.cluster_merge import (
        cluster_merge_reference, fused_cluster_merge,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    names = ["q", "kv", "ncc", "pos", "pe_kernel", "pe_bias", "blank_k",
             "blank_v"]
    R = 224 // 4 - 1
    rows = {"attention": [], "merge": []}
    for label, n, h, c, per_fwd in ATTN_STAGES:
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            a = attention_inputs(torch, gen, 8, n, h, c, dev, dtype)
            out = fused_cluster_attention(*(a[k] for k in names), h, CS, R)
            ref_args = dict(a, q=a["q"].float(), kv=a["kv"].float())
            ref = cluster_attention_reference(
                *(ref_args[k] for k in names), h, CS, R)
            torch.cuda.synchronize()
            errs.append(check(f"attention_{label}",
                              str(dtype).split(".")[1], out, ref))
        a = attention_inputs(torch, gen, 128, n, h, c, dev, torch.bfloat16)
        args = [a[k] for k in names]
        out = fused_cluster_attention(*args, h, CS, R)
        ref = cluster_attention_reference(*args, h, CS, R)  # f32 inside
        torch.cuda.synchronize()
        errs.append(check(f"attention_{label}_b128", "bfloat16", out, ref))
        ms = time_ms(lambda: fused_cluster_attention(*args, h, CS, R))
        plain = time_ms(lambda: cluster_attention_reference(*args, h, CS, R),
                        iters=5, warmup=1)
        moved, flops = attn_work(torch, a, h, CS)
        bms, by = bound_ms(moved, flops, "bfloat16")
        rows["attention"].append(dict(
            shape=label, b=128, n=n, heads=h, c=c, per_forward=per_fwd,
            ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, bytes=moved,
            flops=flops, max_abs_err=max(errs)))
        emit({"phase": "kernel_time", "kernel": "cluster_attention_fwd",
              **rows["attention"][-1]})
    for label, n, n_, c in MERGES:
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            w, f, ncc = merge_inputs(torch, gen, 8, n, n_, c, dev, dtype)
            out = fused_cluster_merge(w, f, ncc, CS)
            ref = cluster_merge_reference(w.float(), f.float(), ncc, CS)
            torch.cuda.synchronize()
            errs.append(check(label, str(dtype).split(".")[1], out, ref))
        w, f, ncc = merge_inputs(torch, gen, 128, n, n_, c, dev,
                                 torch.bfloat16)
        out = fused_cluster_merge(w, f, ncc, CS)
        ref = cluster_merge_reference(w.float(), f.float(), ncc, CS)
        torch.cuda.synchronize()
        errs.append(check(f"{label}_b128", "bfloat16", out, ref))
        ms = time_ms(lambda: fused_cluster_merge(w, f, ncc, CS))
        plain = time_ms(lambda: cluster_merge_reference(w, f, ncc, CS),
                        iters=5, warmup=1)
        moved, flops = merge_work(torch, w, f, ncc, CS)
        bms, by = bound_ms(moved, flops, "bfloat16")
        rows["merge"].append(dict(
            shape=label, b=128, n=n, n_out=n_, c=c, per_forward=1, ms=ms,
            plain_ms=plain, bound_ms=bms, bound_by=by, bytes=moved,
            flops=flops, max_abs_err=max(errs)))
        emit({"phase": "kernel_time", "kernel": "cluster_merge_fwd",
              **rows["merge"][-1]})
    return rows


def mini_config(opts):
    import os

    from ml_autofocusformermod_torch.config import load_config

    here = os.path.dirname(os.path.abspath(__file__))
    return load_config(os.path.join(here, "ml_autofocusformermod_torch",
                                    "configs", "aff_mini.yaml"), opts=opts)


def phase_model(torch):
    import numpy as np

    from ml_autofocusformermod_torch.models.build import build_model
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        fused_cluster_attention,
    )
    from ml_autofocusformermod_torch.ops.cluster_merge import (
        fused_cluster_merge,
    )

    cfg = mini_config(["TPU.COMPUTE_DTYPE", "float32"])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 224, 224)).astype(np.float32))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the patch-embed conv
    try:
        gpu = build_model(cfg, "cuda", seed=0)
        with torch.no_grad():
            fused_cluster_attention.launches = 0
            fused_cluster_merge.launches = 0
            out = gpu(x.cuda()).float().cpu()
            torch.cuda.synchronize()
            launches = (fused_cluster_attention.launches,
                        fused_cluster_merge.launches)
            ref = build_model(cfg, "cpu", seed=0)(x).float()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = (out - ref).abs().max().item()
    same_argmax = bool((out.argmax(-1) == ref.argmax(-1)).all())
    ok = (err <= 1e-3 and same_argmax and launches == (10, 3)
          and bool(out.isfinite().all()) and out.shape == (2, 1000))
    emit({"phase": "model_check", "model": "aff_mini_224", "dtype": "float32",
          "b": 2, "max_abs_err_vs_cpu": err, "same_argmax": same_argmax,
          "launches_per_forward": {"cluster_attention_fwd": launches[0],
                                   "cluster_merge_fwd": launches[1]},
          "ok": ok})
    if not ok:
        raise AssertionError("AFF-Mini GPU forward disagrees with the CPU "
                             "plain path or launched the wrong kernel count")


def run_main(torch, argv):
    """The entry point with the launch counters zeroed just before and read
    just after."""
    from ml_autofocusformermod_torch import main as port_main
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        fused_cluster_attention,
    )
    from ml_autofocusformermod_torch.ops.cluster_merge import (
        fused_cluster_merge,
    )

    fused_cluster_attention.launches = 0
    fused_cluster_merge.launches = 0
    t0 = time.perf_counter()
    result = port_main.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return result, seconds, {"cluster_attention_fwd":
                             fused_cluster_attention.launches,
                             "cluster_merge_fwd": fused_cluster_merge.launches}


def phase_entry(torch, smi):
    import os

    cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "ml_autofocusformermod_torch", "configs",
                       "aff_mini.yaml")
    common = ["--cfg", cfg, "--device", "cuda", "--data-path", "no_dataset"]
    result, secs, launches = run_main(
        torch, common + ["--eval", "--batch-size", "32"])
    forwards = 50 + 30 + 4  # throughput protocol + 128 synthetic images / 32
    ok = (launches == {"cluster_attention_fwd": 10 * forwards,
                       "cluster_merge_fwd": 3 * forwards}
          and all(math.isfinite(v) for v in result.values()))
    emit({"phase": "eval", "batch": 32, "dtype": "bfloat16", **result,
          "seconds": secs, "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"--eval run: launches {launches}")

    result, secs, launches = run_main(
        torch, common + ["--throughput", "--batch-size", "128"])
    forwards = 50 + 30
    ok = (launches == {"cluster_attention_fwd": 10 * forwards,
                       "cluster_merge_fwd": 3 * forwards}
          and result["throughput_img_s"] > 0)
    emit({"phase": "throughput", "model": "aff_mini_224", "batch": 128,
          "dtype": "bfloat16", "img_per_s": result["throughput_img_s"],
          "v100_reference_img_per_s": V100_AFF_MINI_IMG_S, "card": smi,
          "seconds": secs, "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"--throughput run: launches {launches}")
    return launches


def kernels_line(rows, launches):
    def total(rs, key):
        return sum(r[key] * r["per_forward"] for r in rs)

    def entry(name, src, replaces, also, rs):
        return {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "also_replaces": also,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            # per AFF-Mini b128 bf16 forward: sum over its launches
            "ms": total(rs, "ms"), "plain_ms": total(rs, "plain_ms"),
            "bound_ms": total(rs, "bound_ms"),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rs)
                         else "operations"),
            "library_ms": None,  # no single PyTorch call computes it
            "per_shape": rs,
        }

    return {"kernels": [
        entry("cluster_attention_fwd", ATTN_SRC, TPU_ATTN, [TPU_ATTN_STACKED],
              rows["attention"]),
        entry("cluster_merge_fwd", MERGE_SRC, TPU_MERGE, [], rows["merge"]),
    ]}


def main() -> int:
    import torch

    smi = phase_device(torch)
    phase_build()
    rows = phase_kernels(torch)
    phase_model(torch)
    launches = phase_entry(torch, smi)
    emit(kernels_line(rows, launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
