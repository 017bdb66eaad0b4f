"""A profiled stretch of a run, reduced to what the per-layer metrics read.

:func:`profile` runs ``steps`` calls under ``torch.profiler`` (CPU and CUDA
activities, shapes recorded), each inside a ``h100bench.step`` span, ends
in a synchronise, writes the Chrome trace under ``TMPDIR``, reads it back
and deletes it. :func:`summarise` reduces the events:

* the window: from the first step span's start to the later of the last
  span's end and the last device event's end;
* device busy time: the union (not the sum) of the intervals of every
  kernel, copy and set on the device within the window;
* each kernel's launching CPU op: the launch (runtime or driver call, by
  correlation id) and the CPU ops on its thread that enclose it; a kernel
  belongs to its outermost enclosing ``mlaff::`` op, if any, whose work
  :func:`work.op_work` computes from the op's recorded arguments;
* the longest device operations by launching op and kernel name, and the
  idle gaps by what the host was in when each began.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from . import work

STEP_SPAN = "h100bench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
ITEMSIZE = {"c10::BFloat16": (2, "bfloat16"), "c10::Half": (2, "float16"),
            "float": (4, "float32"), "double": (8, "float64"),
            "int": (4, "int32"), "long int": (8, "int64"),
            "bool": (1, "bool"), "unsigned char": (1, "uint8"),
            "signed char": (1, "int8"), "short int": (2, "int16")}


def profile(run_step: Callable[[int], None], steps: int,
            sync: Callable[[], None]) -> List[dict]:
    """The trace events of ``steps`` calls of ``run_step(i)``."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        for i in range(steps):
            with record_function(STEP_SPAN):
                run_step(i)
        sync()
    fd, path = tempfile.mkstemp(prefix="h100bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X"]


class _Thread:
    """The CPU ops of one thread, with their nesting."""

    def __init__(self, ops: List[dict]):
        ops.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        self.ops = ops
        self.starts = [e["ts"] for e in ops]
        self.parent = [-1] * len(ops)
        stack: List[int] = []
        for i, e in enumerate(ops):
            while stack and _end(ops[stack[-1]]) < e["ts"] + e.get("dur", 0):
                if _end(ops[stack[-1]]) <= e["ts"]:
                    stack.pop()
                else:
                    break
            self.parent[i] = stack[-1] if stack else -1
            stack.append(i)

    def chain(self, t: float) -> List[dict]:
        """The ops enclosing time ``t``, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and _end(self.ops[i]) < t:
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(self.ops[i])
            i = self.parent[i]
        return out


def _end(e: dict) -> float:
    return e["ts"] + e.get("dur", 0)


def _args_of(op: dict) -> list:
    """The op's recorded arguments: :class:`work.Arg` for tensors, the
    concrete value (or None) for the rest."""
    a = op.get("args", {})
    dims = a.get("Input Dims", [])
    types = a.get("Input type", [])
    strides = a.get("Input Strides", [])
    concrete = a.get("Concrete Inputs", [])
    out = []
    for i, d in enumerate(dims):
        t = types[i] if i < len(types) else ""
        if t in ITEMSIZE and isinstance(d, list) and d:
            size, name = ITEMSIZE[t]
            st = strides[i] if i < len(strides) and strides[i] else None
            out.append(work.Arg(tuple(d), size, tuple(st) if st else None,
                                name))
        else:
            v = concrete[i] if i < len(concrete) else ""
            try:
                out.append(float(v) if "." in str(v) else int(v))
            except (TypeError, ValueError):
                out.append(None)
    return out


def _fill_scalars(name: str, args: list, cluster_size: int) -> list:
    """Scalars the trace did not record: the head count from the
    positional bias's (5, h) weight, the cluster size from the
    configuration."""
    args = list(args)
    if name.startswith("mlaff::cluster_attention"):
        heads_at, cs_at = (11, 12) if name.endswith("fwd") else (14, 15)
        while len(args) <= cs_at:
            args.append(None)
        if args[heads_at] is None:
            args[heads_at] = args[4].shape[1]
        if args[cs_at] is None:
            args[cs_at] = cluster_size
    elif name.startswith("mlaff::cluster_merge"):
        while len(args) <= 3:
            args.append(None)
        if args[3] is None:
            args[3] = cluster_size
    return args


def summarise(events: List[dict], steps: int,
              cluster_size: int) -> Dict[str, object]:
    """What the metric readers read (seconds throughout)."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == STEP_SPAN]
    if not spans:
        raise RuntimeError("the trace holds no step span")
    start = min(e["ts"] for e in spans)
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] >= start]
    end = max([_end(e) for e in spans] + [_end(e) for e in device])
    threads: Dict[object, list] = defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op":
            threads[e.get("tid")].append(e)
    threads = {t: _Thread(ops) for t, ops in threads.items()}
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}

    # device busy time and idle gaps over the window
    ivals = sorted((e["ts"], min(_end(e), end)) for e in device)
    busy, gaps, cur = 0.0, [], start
    for s, t in ivals:
        if s > cur:
            gaps.append((cur, s))
        if t > cur:
            busy += t - max(s, cur)
            cur = t
    if end > cur:
        gaps.append((cur, end))

    # kernels by launching op
    per_op: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0, 0])
    seen_ops = set()
    by_label: Dict[str, float] = defaultdict(float)
    kernels = 0
    for e in device:
        if e.get("cat") != "kernel":
            continue
        kernels += 1
        chain: List[dict] = []
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None and launch.get("tid") in threads:
            chain = threads[launch["tid"]].chain(launch["ts"])
        ml = [o for o in chain if o["name"].startswith("mlaff::")]
        op = ml[-1] if ml else next(
            (o for o in chain if o["name"].startswith("aten::")),
            chain[0] if chain else None)
        opname = op["name"] if op is not None else "unattributed"
        by_label[f"{opname} | {e['name'][:96]}"] += e.get("dur", 0) / 1e6
        if ml:
            rec = per_op[opname]
            rec[0] += e.get("dur", 0) / 1e6
            key = (op.get("tid"), op["ts"], opname)
            if key not in seen_ops:
                seen_ops.add(key)
                w = work.op_work(opname, _fill_scalars(
                    opname, _args_of(op), cluster_size))
                if w is not None:
                    rec[1] += work.least_seconds(*w)
                rec[2] += 1

    idle: Dict[str, float] = defaultdict(float)
    for s, t in gaps:
        inner = [c[0] for c in (th.chain(s) for th in threads.values())
                 if c]
        label = max(inner, key=lambda o: o["ts"])["name"] if inner \
            else "host between ops"
        idle[label] += (t - s) / 1e6

    def top(d: Dict[str, float]) -> List[list]:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]

    return {
        "steps": steps,
        "window_s": (end - start) / 1e6,
        "busy_s": busy / 1e6,
        "kernels": kernels,
        "ops": {k: {"kernel_s": v[0], "least_s": v[1], "calls": v[2]}
                for k, v in per_op.items()},
        "device_ops": top(by_label),
        "idle_gaps": top(idle),
    }


def roofline(summary: Dict[str, object], ops) -> Optional[float]:
    """Percent of the least time over the kernel time of the kernels
    launched inside ``ops``; None when none ran."""
    recs = [summary["ops"][k] for k in ops if k in summary["ops"]]
    kernel_s = sum(r["kernel_s"] for r in recs)
    if kernel_s <= 0:
        return None
    return 100.0 * sum(r["least_s"] for r in recs) / kernel_s
