"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, one JSON line each:

1. device: the card (``nvidia-smi`` name and power limit), torch, CUDA and
   nvcc versions;
2. build: every CUDA kernel of ``ml_autofocusformermod_torch/csrc``, built
   from source with nvcc (one process per source, all at once);
3. kernel_check: each forward kernel against its plain PyTorch version at
   every AFF-Mini 224 shape of the forward (attention at stages 1-3, merges
   1-3), b = 8, fp32 (max abs <= 1e-4 * max|ref|) and bf16 (plain version
   in f32 on the same bf16 inputs, max abs <= 2e-2 * max|ref|); then, at
   b = 128 bf16, the shapes of the throughput run, the same bf16 check and
   the kernel's and the plain version's median time (CUDA events) beside
   the least time the card could take;
4. kernel_check, backward: the same for the two backward kernels against
   their plain backwards, every output (attention: dq, dkv, d_pe_kernel,
   d_pe_bias, d_blank_k, d_blank_v; merge: dw, dfeat) at the same six
   shapes, b = 8 fp32 and bf16, then b = 128 bf16 with times and bound;
5. model_check: AFF-Mini 224 built through ``build_model`` and the port's
   ``aff_mini.yaml`` from a fixed seed, fp32, b = 2: the GPU forward (CUDA
   kernels, TF32 off) against the CPU forward (plain versions) on the same
   weights, logits within 1e-3 and the same argmax; 10 attention and 3
   merge launches per forward;
6. train_check: one ``make_train_step`` step of the same model, fp32,
   b = 2, on the GPU (kernels, TF32 off) against the same step on the CPU
   (plain versions) from the same weights: loss and grad_norm within 1e-4
   relative, every parameter gradient within 1e-3 * max|ref| of its tensor
   (max|ref| floored at 1e-5 of the gradient norm, for gradients that are
   zero in exact arithmetic),
   the BatchNorm running stats within 1e-5 * max|ref| (the two devices
   reduce in another order); 10 + 10 attention and 3 + 3 merge launches
   (forward + backward) per step;
7. eval / throughput: the entry point ``ml_autofocusformermod_torch.main``
   with ``--eval`` over a few synthetic batches, then ``--throughput`` at
   b = 128 in bf16 (50 warmup + 30 timed forwards);
8. train: the entry point training AFF-Mini 224 in bf16 at b = 128 for one
   synthetic epoch (4 steps), one checkpoint and one validation; training
   images/s beside the card's name and power limit.

The launch counters are zeroed just before each run of the entry point
and read just after.

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
CSRC = "ml_autofocusformermod_torch/csrc/"
TPU_CLUSTEN = "ml_autofocusformermod_tpu/ops/clusten_pallas.py:"
TPU_MERGE = "ml_autofocusformermod_tpu/ops/merge_pallas.py:"
# name: (source, the TPU kernel it replaces, others it also replaces)
KERNELS = {
    "cluster_attention_fwd": ("cluster_attention.cu", TPU_CLUSTEN + "740",
                              [TPU_CLUSTEN + "965"]),
    "cluster_attention_bwd": ("cluster_attention_bwd.cu",
                              TPU_CLUSTEN + "1764", [TPU_CLUSTEN + "1127"]),
    "cluster_merge_fwd": ("cluster_merge.cu", TPU_MERGE + "199", []),
    "cluster_merge_bwd": ("cluster_merge_bwd.cu", TPU_MERGE + "304", []),
}

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


def attn_bwd_work(torch, args, g, h, cs):
    """(bytes, flops) of one attention backward: inputs (those of the
    forward and g) read once, dq, dkv and the parameter gradients written
    once; per slot that holds a token, q.k, g.v, dq, dk and dv (each 2 c_)
    plus the geometry and the softmax terms."""
    from ml_autofocusformermod_torch.ops.cluster_gather import (
        cluster_token_index,
    )

    q, kv, ncc = args["q"], args["kv"], args["ncc"]
    b, n, c = q.shape
    c_ = c // h
    valid = (cluster_token_index(ncc, cs) < n).sum().item()
    moved = (nbytes(*args.values(), g) + nbytes(q, kv)
             + nbytes(*(args[k] for k in ("pe_kernel", "pe_bias", "blank_k",
                                          "blank_v"))))
    flops = valid * h * (10 * c_ + 24) + b * n * h * 8 * c_
    return moved, flops


def merge_bwd_work(torch, w, feat, ncc, g, cs):
    """(bytes, flops) of one merge backward: w, feat, ncc, g read once, dw
    and dfeat written once; per gathered row 2 * ic * c flops for dw and
    for dfeat each."""
    from ml_autofocusformermod_torch.ops.cluster_gather import (
        cluster_token_index,
    )

    b, n_, _, ic = w.shape
    n, c = feat.shape[1], feat.shape[2]
    valid = (cluster_token_index(ncc, cs) < n).sum().item()
    return nbytes(w, feat, ncc, g) + nbytes(w, feat), valid * ic * c * 4


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
            shape=label, b=128, n=n, heads=h, c=c, per_pass=per_fwd,
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
            shape=label, b=128, n=n, n_out=n_, c=c, per_pass=1, ms=ms,
            plain_ms=plain, bound_ms=bms, bound_by=by, bytes=moved,
            flops=flops, max_abs_err=max(errs)))
        emit({"phase": "kernel_time", "kernel": "cluster_merge_fwd",
              **rows["merge"][-1]})
    return rows


def phase_kernels_bwd(torch):
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_backward, cluster_attention_backward_reference,
    )
    from ml_autofocusformermod_torch.ops.cluster_merge import (
        cluster_merge_backward, cluster_merge_backward_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    names = ["q", "kv", "ncc", "pos", "pe_kernel", "pe_bias", "blank_k",
             "blank_v"]
    outs = ["dq", "dkv", "d_pe_kernel", "d_pe_bias", "d_blank_k", "d_blank_v"]
    R = 224 // 4 - 1
    rows = {"attention": [], "merge": []}

    def f32(t):
        return t.float() if t.is_floating_point() else t

    for label, n, h, c, per_step in ATTN_STAGES:
        errs = []
        for b, dtype in ((8, torch.float32), (8, torch.bfloat16),
                         (128, torch.bfloat16)):
            a = attention_inputs(torch, gen, b, n, h, c, dev, dtype)
            g = torch.randn(b, n, c, generator=gen).to(dev, dtype)
            args = [a[k] for k in names]
            got = cluster_attention_backward(*args, g, h, CS, R)
            want = cluster_attention_backward_reference(
                *(f32(t) for t in args), g.float(), h, CS, R)
            torch.cuda.synchronize()
            tag = f"attention_bwd_{label}" + ("_b128" if b == 128 else "")
            for o, x, y in zip(outs, got, want):
                errs.append(check(f"{tag}_{o}", str(dtype).split(".")[1], x, y))
        ms = time_ms(lambda: cluster_attention_backward(*args, g, h, CS, R))
        plain = time_ms(lambda: cluster_attention_backward_reference(
            *args, g, h, CS, R), iters=5, warmup=1)
        moved, flops = attn_bwd_work(torch, a, g, h, CS)
        bms, by = bound_ms(moved, flops, "bfloat16")
        rows["attention"].append(dict(
            shape=label, b=128, n=n, heads=h, c=c, per_pass=per_step, ms=ms,
            plain_ms=plain, bound_ms=bms, bound_by=by, bytes=moved,
            flops=flops, max_abs_err=max(errs)))
        emit({"phase": "kernel_time", "kernel": "cluster_attention_bwd",
              **rows["attention"][-1]})
    for label, n, n_, c in MERGES:
        errs = []
        for b, dtype in ((8, torch.float32), (8, torch.bfloat16),
                         (128, torch.bfloat16)):
            w, f, ncc = merge_inputs(torch, gen, b, n, n_, c, dev, dtype)
            g = torch.randn(b, n_, IC, c, generator=gen).to(dev, dtype)
            got = cluster_merge_backward(w, f, ncc, CS, g)
            want = cluster_merge_backward_reference(w.float(), f.float(), ncc,
                                                    CS, g.float())
            torch.cuda.synchronize()
            tag = f"{label}_bwd" + ("_b128" if b == 128 else "")
            for o, x, y in zip(("dw", "dfeat"), got, want):
                errs.append(check(f"{tag}_{o}", str(dtype).split(".")[1], x, y))
        ms = time_ms(lambda: cluster_merge_backward(w, f, ncc, CS, g))
        plain = time_ms(lambda: cluster_merge_backward_reference(
            w, f, ncc, CS, g), iters=5, warmup=1)
        moved, flops = merge_bwd_work(torch, w, f, ncc, g, CS)
        bms, by = bound_ms(moved, flops, "bfloat16")
        rows["merge"].append(dict(
            shape=label, b=128, n=n, n_out=n_, c=c, per_pass=1, ms=ms,
            plain_ms=plain, bound_ms=bms, bound_by=by, bytes=moved,
            flops=flops, max_abs_err=max(errs)))
        emit({"phase": "kernel_time", "kernel": "cluster_merge_bwd",
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


def counters():
    """The launch counters of the four kernel wrappers, by kernel name."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_backward, fused_cluster_attention,
    )
    from ml_autofocusformermod_torch.ops.cluster_merge import (
        cluster_merge_backward, fused_cluster_merge,
    )

    return {"cluster_attention_fwd": fused_cluster_attention,
            "cluster_attention_bwd": cluster_attention_backward,
            "cluster_merge_fwd": fused_cluster_merge,
            "cluster_merge_bwd": cluster_merge_backward}


def zero_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {k: fn.launches for k, fn in counters().items()}


def phase_train_check(torch):
    import numpy as np

    from ml_autofocusformermod_torch.models.build import build_model
    from ml_autofocusformermod_torch.train.trainer import (
        create_train_state, make_train_step,
    )

    cfg = mini_config(["TPU.COMPUTE_DTYPE", "float32"])
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 224, 224)).astype(
        np.float32))
    y = torch.tensor([3, 977])

    def one_step(device):
        model = build_model(cfg, device, seed=0)
        state, schedule = create_train_state(cfg, model, 10)
        step = make_train_step(cfg, state, schedule)
        out = step(x.to(device), y.to(device))
        grads = {k: p.grad.float().cpu() for k, p in model.named_parameters()}
        stats = {k: b.float().cpu() for k, b in model.named_buffers()
                 if k.endswith(("running_mean", "running_var"))}
        return out, grads, stats

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the patch-embed convs
    try:
        zero_counters()
        out, grads, stats = one_step("cuda")
        torch.cuda.synchronize()
        launches = read_counters()
        ref, ref_grads, ref_stats = one_step("cpu")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    loss, ref_loss = out["loss"].item(), ref["loss"].item()
    gn, ref_gn = out["grad_norm"].item(), ref["grad_norm"].item()
    # a gradient that is zero in exact arithmetic (the patch-embed conv
    # bias ahead of a training-mode BatchNorm, whose batch mean removes any
    # per-channel constant) is round-off on both devices: each tensor's
    # scale is floored at 1e-5 of the global gradient norm
    floor = 1e-5 * ref["grad_norm"].item()
    worst = max(((grads[k] - g).abs().max().item()
                 / max(g.abs().max().item(), floor), k)
                for k, g in ref_grads.items())
    floored = sorted(k for k, g in ref_grads.items()
                     if g.abs().max().item() < floor)
    stat_err = max((stats[k] - t).abs().max().item()
                   / max(t.abs().max().item(), 1e-30)
                   for k, t in ref_stats.items())
    want = {"cluster_attention_fwd": 10, "cluster_attention_bwd": 10,
            "cluster_merge_fwd": 3, "cluster_merge_bwd": 3}
    ok = (abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)
          and abs(gn - ref_gn) <= 1e-4 * abs(ref_gn)
          and worst[0] <= 1e-3 and stat_err <= 1e-5
          and launches == want and out["grads_finite"]
          and math.isfinite(loss))
    emit({"phase": "train_check", "model": "aff_mini_224", "dtype": "float32",
          "b": 2, "loss": loss, "loss_cpu": ref_loss, "grad_norm": gn,
          "grad_norm_cpu": ref_gn, "worst_grad_rel_err": worst[0],
          "worst_grad": worst[1], "grads_at_floor": floored,
          "bn_stats_rel_err": stat_err,
          "launches_per_step": launches, "ok": ok})
    if not ok:
        raise AssertionError("AFF-Mini GPU train step disagrees with the CPU "
                             "plain path or launched the wrong kernel count")


def run_main(torch, argv):
    """The entry point with the launch counters zeroed just before and read
    just after."""
    from ml_autofocusformermod_torch import main as port_main

    zero_counters()
    t0 = time.perf_counter()
    result = port_main.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return result, seconds, read_counters()


def expect(fwd_passes, train_steps=0):
    """Launches of the four kernels for ``fwd_passes`` forwards outside
    training and ``train_steps`` train steps of AFF-Mini."""
    f = fwd_passes + train_steps
    return {"cluster_attention_fwd": 10 * f,
            "cluster_attention_bwd": 10 * train_steps,
            "cluster_merge_fwd": 3 * f, "cluster_merge_bwd": 3 * train_steps}


def phase_entry(torch, smi):
    import os

    cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "ml_autofocusformermod_torch", "configs",
                       "aff_mini.yaml")
    common = ["--cfg", cfg, "--device", "cuda", "--data-path", "no_dataset"]
    result, secs, launches = run_main(
        torch, common + ["--eval", "--batch-size", "32"])
    forwards = 50 + 30 + 4  # throughput protocol + 128 synthetic images / 32
    ok = (launches == expect(forwards)
          and all(math.isfinite(v) for v in result.values()))
    emit({"phase": "eval", "batch": 32, "dtype": "bfloat16", **result,
          "seconds": secs, "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"--eval run: launches {launches}")

    result, secs, launches = run_main(
        torch, common + ["--throughput", "--batch-size", "128"])
    ok = launches == expect(50 + 30) and result["throughput_img_s"] > 0
    emit({"phase": "throughput", "model": "aff_mini_224", "batch": 128,
          "dtype": "bfloat16", "img_per_s": result["throughput_img_s"],
          "v100_reference_img_per_s": V100_AFF_MINI_IMG_S, "card": smi,
          "seconds": secs, "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"--throughput run: launches {launches}")
    return launches


def phase_train(torch, smi):
    """``main`` training AFF-Mini 224 bf16 b128 for one synthetic epoch."""
    import os
    import shutil
    import tempfile

    cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "ml_autofocusformermod_torch", "configs",
                       "aff_mini.yaml")
    out = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        result, secs, launches = run_main(torch, [
            "--cfg", cfg, "--device", "cuda", "--data-path", "no_dataset",
            "--batch-size", "128", "--epochs", "1", "--output", out])
        train = result["train"]
        ckpt = os.path.exists(train["checkpoint"])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    steps = train["steps"]
    # throughput protocol, the train steps, 512 validation images / 128
    ok = (launches == expect(50 + 30 + 4, steps) and steps == 4
          and train["skipped_steps"] == 0 and ckpt
          and all(math.isfinite(v) for v in (train["train_loss"],
                                             train["last_grad_norm"],
                                             train["val_loss"])))
    emit({"phase": "train", "model": "aff_mini_224", "batch": 128,
          "dtype": "bfloat16", "steps": steps,
          "img_per_s": train["train_img_s"],
          "img_per_s_after_first": train["train_img_s_after_first"],
          "step_seconds": train["step_seconds"],
          "train_loss": train["train_loss"],
          "last_grad_norm": train["last_grad_norm"],
          "val_loss": train["val_loss"], "checkpoint_written": ckpt,
          "card": smi, "seconds": secs, "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"training run: launches {launches}, {train}")
    return launches


def kernels_line(rows, launches):
    """One entry per CUDA kernel: launches in the training run of the entry
    point (the path that runs all four), the worst check error, and per
    AFF-Mini b128 bf16 pass (a forward for the forward kernels, a backward
    for the backward kernels) the sum of the per-call times over the
    pass's launches."""
    def total(rs, key):
        return sum(r[key] * r["per_pass"] for r in rs)

    out = []
    for name, (src, replaces, also) in KERNELS.items():
        rs = rows[name]
        out.append({
            "name": name, "route": "cuda", "source": CSRC + src,
            "replaces": replaces, "also_replaces": also,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": total(rs, "ms"), "plain_ms": total(rs, "plain_ms"),
            "bound_ms": total(rs, "bound_ms"),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rs)
                         else "operations"),
            "library_ms": None,  # no single PyTorch call computes it
            "per_shape": rs,
        })
    return {"kernels": out}


def main() -> int:
    import torch

    smi = phase_device(torch)
    phase_build()
    fwd = phase_kernels(torch)
    bwd = phase_kernels_bwd(torch)
    rows = {"cluster_attention_fwd": fwd["attention"],
            "cluster_attention_bwd": bwd["attention"],
            "cluster_merge_fwd": fwd["merge"],
            "cluster_merge_bwd": bwd["merge"]}
    phase_model(torch)
    phase_train_check(torch)
    phase_entry(torch, smi)
    launches = phase_train(torch, smi)
    emit(kernels_line(rows, launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
