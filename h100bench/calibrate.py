"""Readings to set a cell's limits from, in one process.

    python3 -m h100bench.calibrate --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--fault-seeds 7,8,9] [--seconds 2]

For each of ``--seeds`` the cell runs as in a benchmark run (set-up, a
window of ``--seconds``, the check) and prints the program's readings:
the lower readings of the limits. For each of ``--control-seeds`` the
correctness control takes the program's place: the plain reference with
every product's operands rounded to float8 e4m3 (the step below the
configuration's bfloat16), on the same inputs and at the same sizes, and
its readings against the float32 reference are printed: the upper
readings. For each of ``--fault-seeds`` the cell runs with each fault it
can have (``faults.py::planted``) planted in the program's timed path,
and its readings are printed: the upper readings of a number the control
does not separate.
One JSON line per reading. Needs the card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, faults, loops, run


def control_readings(loop) -> dict:
    """The control's numbers for ``loop``'s cell and seed."""
    if isinstance(loop, loops.TrainLoop):
        low, ref = loop.replay("fp8"), loop.replay("float32")
        return check.train_readings(low["losses"], low["grads"],
                                    ref["start"], low["params"], ref)
    low, ref = loop.answers("fp8"), loop.answers("float32")
    return {"logit_gap": max(check.logit_gap(a, b)
                             for a, b in zip(low, ref))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = run.load_json(run.Path.cwd() / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"]
                if w["name"] == args.workload)
    cfg = run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" /
                            f"{cell['traffic']}.json")
    kind = loops.KINDS[traffic["kind"]]
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        loop = kind(cfg, traffic, seed, "cuda")
        loop.setup()
        loop.window(args.seconds)
        t1 = time.perf_counter()
        readings = loop.check()
        print(json.dumps({"workload": args.workload, "side": "program",
                          "seed": seed, "run_s": t1 - t0,
                          "check_s": time.perf_counter() - t1,
                          **readings}), flush=True)
        del loop
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        loop = kind(cfg, traffic, seed, "cuda")
        readings = control_readings(loop)
        print(json.dumps({"workload": args.workload, "side": "control",
                          "seed": seed, "check_s": time.perf_counter() - t0,
                          **readings}), flush=True)
        del loop
    planted = faults.planted(cfg, traffic["kind"])
    for seed in [int(s) for s in args.fault_seeds.split(",") if s]:
        for name, fault in planted.items():
            loop = kind(cfg, traffic, seed, "cuda", mutate=fault)
            loop.setup()
            loop.window(args.seconds)
            readings = loop.check()
            print(json.dumps({"workload": args.workload, "side": name,
                              "seed": seed, **readings}), flush=True)
            del loop
    return 0


if __name__ == "__main__":
    sys.exit(main())
