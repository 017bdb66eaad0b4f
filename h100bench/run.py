"""Run one cell of the benchmark once.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. Set-up builds
the package's kernels (cached in the checkout), the model with weights
made from the seed, the cell's inputs, and runs the cell's warm-up; then
the window runs for ``--seconds``. With ``--trace 0`` the result line holds
the cell's end-to-end metrics; with ``--trace 1`` an unprofiled stretch of
``--seconds`` and a profiled one of the traffic's ``trace_steps`` calls
give its per-layer metrics, read by ``metrics/<name>.py``. Either way
the window's answers are then checked against the plain reference, each
compared number printed beside its limit on standard error, and the
result is the last line of standard output.

Everything a cell needs is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``kind`` picks the loop of
:mod:`loops`), ``limits/<workload>.json`` and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is everything from here to the window

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_autofocusformermod_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_entries(bench: dict, cell: str, section: str) -> list:
    """The ``section`` metrics that ``cell`` reports: those that list it,
    and those without a list whose ``moves`` (or, end to end, which) the
    cell reports."""
    if section == "end_to_end":
        return [m for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])]
    e2e = {m["name"] for m in cell_entries(bench, cell, "end_to_end")}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in e2e)]


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(
        f"h100bench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def card() -> dict:
    import torch

    out = {"kind": torch.cuda.get_device_name(0), "power_limit": "unknown"}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        if smi.returncode == 0 and smi.stdout.strip():
            out["power_limit"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return out


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             traced: bool, device: str = "cuda", start: float = T0,
             mutate=None, traffic_sizes: dict = None,
             opts: dict = None) -> dict:
    """One run of the cell ``name``; returns the result line's object
    (without ``device.kind``). Tests on the CPU shrink the traffic with
    ``traffic_sizes``, change the program's configuration with ``opts``
    and plant a fault in the timed path with ``mutate``."""
    from . import check, loops, trace

    cell = next(w for w in bench["workloads"] if w["name"] == name)
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    traffic.update(traffic_sizes or {})
    cfg["opts"].update(opts or {})
    limits = load_json(HERE / "limits" / f"{name}.json")
    loop = loops.KINDS[traffic["kind"]](cfg, traffic, seed, device, mutate)
    loop.setup()
    setup_s = time.perf_counter() - start
    e2e = loop.window(seconds)
    t_window = time.perf_counter()
    result = {"correct": False, "attempted": loop.attempted,
              "failed": loop.failed, "metrics": {},
              "device": {"platform": "gpu", "count": int(cell["chips"]),
                         "memory_peak_bytes": e2e["peak_bytes"]}}
    e2e["setup_s"] = setup_s
    if traced:
        steps = int(traffic["trace_steps"])
        summary = trace.summarise(loop.profile(steps), steps,
                                  _cluster_size(cfg))
        run = SimpleNamespace(summary=summary, rate_img_s=e2e["rate_img_s"],
                              flops_per_image=cfg["gflops_per_image"] * 1e9)
        for m in cell_entries(bench, name, "per_layer"):
            value = load_metric(m["name"]).read(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    else:
        for m in cell_entries(bench, name, "end_to_end"):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    t_check = time.perf_counter()
    readings = loop.check()
    ok, rows = check.verdict(readings, limits)
    result["correct"] = bool(ok and loop.failed == 0)
    gaps = sorted(b - a for a, b in zip(loop.returns, loop.returns[1:]))
    result["notes"] = {
        **{k[1:]: v for k, v in readings.items() if k.startswith("_")},
        "call_ms_min_median_max": [1e3 * gaps[0], 1e3 * gaps[len(gaps) // 2],
                                   1e3 * gaps[-1]],
        "setup_s": setup_s, "after_window_s": t_check - t_window,
        "check_s": time.perf_counter() - t_check}
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in rows}
    return result


def _cluster_size(cfg: dict) -> int:
    model = cfg["model"]
    if "arch" in model:
        return int(model["arch"]["cluster_size"])
    return int(model["mr"]["cluster_size"][0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path.cwd()
    bench = load_json(root / "BENCHMARK.json")
    names = [w["name"] for w in bench["workloads"]]
    if args.workload not in names:
        print(f"unknown workload {args.workload!r}: {names}",
              file=sys.stderr)
        return 2
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    cache = root / ".cache" / "h100bench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s): torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count = "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    info = card()
    print(f"card: {info['kind']}; nvidia-smi name, power.limit: "
          f"{info['power_limit']}", flush=True)
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    result["device"]["kind"] = info["kind"]
    bad = forbidden_modules()
    if bad:
        print(f"loaded {bad}: the benchmark's process must not import "
              "them", file=sys.stderr)
        return 3
    for k, v in result.pop("notes").items():
        print(f"note {k} = {v!r}", file=sys.stderr)
    compared = result.pop("compared")
    result["compared"] = compared
    for n, c in compared.items():
        print(f"compared {n} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
