"""The program's own spans in a profiled stretch of a cell.

    python3 -m h100bench.spans --workload <cell> --seed <n> \
        [--seconds 5] [--repeats 2] [--out spans.jsonl]

from the root of a checkout, on the card. Set-up is ``run.py``'s; an
unprofiled stretch of ``--seconds`` gives the call time without the
profiler; then each repeat profiles the traffic's ``trace_steps`` calls
with :func:`trace.profile` (the traced run's own profiler settings, each
call in a ``h100bench.step`` span) and prints one JSON line: what
:func:`summarise` makes of the events, and the per-layer readings of
:data:`READERS`. The benchmark's traced run does not read these yet:
``trace.summarise`` returns no spans.

:func:`summarise` reduces the events to, for each program span name
(``cat == "user_annotation"``, other than ``h100bench.step``), seconds
over the profiled calls:

* ``calls`` and ``host_s``, the spans' summed durations;
* ``self_s``: ``host_s`` less the part of it covered by ``sync.*`` spans
  nested inside (a sync span's own ``self_s`` is its ``host_s``);
* ``kernel_s``: the device time of the kernels whose launch event
  (matched by correlation id) lies inside the span, on its thread;
* ``idle_s``: the device idle gaps of the window (``trace.summarise``'s
  window and gaps) that began while this was the innermost program span
  open on any thread; gaps with none open go to ``idle_outside_s``;

and counts ``syncs``, the host's blocking points inside the profiled
calls (not the profiler's closing synchronise): a CPU op that holds a
``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` or
``cudaEventSynchronize`` call, or the launch of a ``Memcpy DtoH``, each op
once. ``unspanned`` lists the blocking points outside every ``sync.*``
span by their chain of spans and ops, outermost first.

The host times are taken under the profiler (shapes recorded), which
lengthens every host op: compare them with each other, not with
unprofiled step times, and a repeat with the same repeat. The first
profiled stretch of a process is the slowest (on an H100 it read
AFF-Mini's backward at 2.8x the second's); the benchmark's traced run
profiles once, so it reads a first stretch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, List, Optional

from .trace import DEVICE_CATS, LAUNCH_CATS, STEP_SPAN, _end, _Thread

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
PHASES = ("train_step.forward", "train_step.backward",
          "train_step.optimizer")


def _step_spans(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == STEP_SPAN]


def _window(events: List[dict]):
    """(start, end, device events, idle gaps) as ``trace.summarise``
    takes them (microseconds)."""
    steps = _step_spans(events)
    if not steps:
        raise RuntimeError("the trace holds no step span")
    start = min(e["ts"] for e in steps)
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] >= start]
    end = max([_end(e) for e in steps] + [_end(e) for e in device])
    gaps, cur = [], start
    for s, t in sorted((e["ts"], min(_end(e), end)) for e in device):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if end > cur:
        gaps.append((cur, end))
    return start, end, device, gaps


def _threads(events: List[dict], keep) -> Dict[object, _Thread]:
    by_tid: Dict[object, list] = defaultdict(list)
    for e in events:
        if keep(e):
            by_tid[e.get("tid")].append(e)
    return {t: _Thread(evs) for t, evs in by_tid.items()}


def summarise(events: List[dict], steps: int) -> Dict[str, object]:
    """The program spans and host syncs of a profiled stretch (seconds)."""
    start, end, device, gaps = _window(events)
    spans = _threads(events, lambda e: e.get("cat") == "user_annotation"
                     and e.get("name") != STEP_SPAN
                     and start <= e["ts"] <= end)
    ops = _threads(events, lambda e: e.get("cat") == "cpu_op")
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}

    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"calls": 0, "host_s": 0.0, "self_s": 0.0, "kernel_s": 0.0,
                 "idle_s": 0.0})
    for th in spans.values():
        for e in th.ops:
            rec = out[e["name"]]
            rec["calls"] += 1
            rec["host_s"] += e.get("dur", 0) / 1e6
            synced = sum(s.get("dur", 0) for s in th.ops
                         if s is not e and s["name"].startswith("sync.")
                         and e["ts"] <= s["ts"] and _end(s) <= _end(e))
            rec["self_s"] += (e.get("dur", 0) - synced) / 1e6

    for k in device:
        if k.get("cat") != "kernel":
            continue
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is None or launch.get("tid") not in spans:
            continue
        for e in spans[launch["tid"]].chain(launch["ts"]):
            out[e["name"]]["kernel_s"] += k.get("dur", 0) / 1e6

    idle_outside = 0.0
    for s, t in gaps:
        inner = [c[0] for c in (th.chain(s) for th in spans.values()) if c]
        if inner:
            out[max(inner, key=lambda e: e["ts"])["name"]]["idle_s"] += \
                (t - s) / 1e6
        else:
            idle_outside += (t - s) / 1e6

    # blocking points: the innermost CPU op around each sync call or
    # device-to-host copy's launch (the call itself where none is open)
    calls = _step_spans(events)
    points = {}
    for e in events:
        call = None
        if e.get("cat") in LAUNCH_CATS and e.get("name") in SYNC_CALLS:
            call = e
        elif e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", ""):
            call = launches.get(e.get("args", {}).get("correlation"))
        if call is None or not any(c["ts"] <= call["ts"] <= _end(c)
                                   for c in calls):
            continue
        th = ops.get(call.get("tid"))
        chain = th.chain(call["ts"]) if th is not None else []
        op = chain[0] if chain else call
        points[(call.get("tid"), op["ts"], op["name"])] = (call, chain)
    unspanned: Counter = Counter()
    for call, chain in points.values():
        th = spans.get(call.get("tid"))
        around = th.chain(call["ts"]) if th is not None else []
        if not any(e["name"].startswith("sync.") for e in around):
            names = [e["name"] for e in reversed(around)]
            names += [e["name"] for e in reversed(chain)] or [call["name"]]
            unspanned[" > ".join(names)] += 1

    return {
        "steps": steps,
        "call_s": sum(c.get("dur", 0) for c in calls) / len(calls) / 1e6,
        "window_s": (end - start) / 1e6,
        "spans": dict(out),
        "idle_outside_s": idle_outside,
        "syncs": len(points),
        "unspanned": unspanned.most_common(),
    }


def _sum(summary: dict, prefix: str, key: str) -> Optional[float]:
    recs = [r for n, r in summary["spans"].items() if n.startswith(prefix)]
    return sum(r[key] for r in recs) if recs else None


def _per_call_ms(summary: dict, prefix: str, key: str) -> Optional[float]:
    v = _sum(summary, prefix, key)
    return None if v is None else 1e3 * v / summary["steps"]


READERS = {
    "forward_host_ms.train":
        lambda s: _per_call_ms(s, "train_step.forward", "self_s"),
    "backward_host_ms.train":
        lambda s: _per_call_ms(s, "train_step.backward", "self_s"),
    "optimizer_host_ms.train":
        lambda s: _per_call_ms(s, "train_step.optimizer", "self_s"),
    "sync_wait_ms.train": lambda s: _per_call_ms(s, "sync.", "host_s"),
    "host_syncs.train": lambda s: s["syncs"] / s["steps"],
    "geometry_ms.train": lambda s: _per_call_ms(s, "geom.", "kernel_s"),
    "geometry_ms.infer": lambda s: _per_call_ms(s, "geom.", "kernel_s"),
    "host_syncs.latency": lambda s: s["syncs"] / s["steps"],
}
"""Per-layer readings of a summary, per profiled call (None where the
program opened no such span)."""


def step_shares(summary: dict) -> Optional[Dict[str, float]]:
    """Of the ``train_step`` spans: the share of their host time the three
    phase spans cover, and the share of the idle time inside them that
    fell to a phase span or one nested in it."""
    step = summary["spans"].get("train_step")
    if step is None:
        return None
    phases = sum(summary["spans"].get(p, {}).get("host_s", 0.0)
                 for p in PHASES)
    nested = sum(r["idle_s"] for n, r in summary["spans"].items()
                 if n.startswith(("train_step.", "sync.", "geom.")))
    idle = nested + step["idle_s"]
    return {"phases_of_step": phases / step["host_s"],
            "idle_in_phases": nested / idle if idle > 0 else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args(argv)

    from . import loops, run, trace

    root = Path.cwd()
    bench = run.load_json(root / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cache = root / ".cache" / "h100bench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cfg = run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    loop = loops.KINDS[traffic["kind"]](cfg, traffic, args.seed, "cuda")
    loop.setup()
    e2e = loop.window(args.seconds)
    steps = int(traffic["trace_steps"])
    for r in range(args.repeats):
        events = loop.profile(steps)
        summary = summarise(events, steps)
        base = trace.summarise(events, steps, run._cluster_size(cfg))
        line = {"workload": args.workload, "seed": args.seed, "repeat": r,
                "card": run.card(), "unprofiled_call_s":
                    (loop.returns[-1] - loop.returns[0]) / loop.attempted,
                "unprofiled_rate_img_s": e2e["rate_img_s"],
                "busy_s": base["busy_s"], "kernels": base["kernels"],
                "readings": {k: f(summary) for k, f in READERS.items()},
                "step_shares": step_shares(summary), **summary}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
