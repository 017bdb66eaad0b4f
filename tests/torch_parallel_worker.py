"""One rank of the port's multi-process CPU tests (gloo).

    RANK=r WORLD_SIZE=W python tests/torch_parallel_worker.py SPEC.json

Imports torch and the port only, never JAX, so ranks start quickly. The
spec names a ``file://`` rendezvous, an output directory and a list of
cases; each case builds a model from a port config, lays it out over a
``(data, model)`` mesh (``parallel/mesh.py``), optionally with ZeRO-1,
loads the same weights on every rank, takes train steps on this data
rank's rows of the given global batches and records, per step, the loss
and grad norm. After the steps it records the one-process layout of the
train state (gathered as a checkpoint gathers it) and this rank's own
blocks. ``rank<r>.pt`` in the output directory holds the results by case.

A case (dict): ``name``; ``cfg`` and ``opts`` (the port config);
``data``, ``model``, ``zero1``; ``batches`` (a ``torch.save`` of a list of
``(images NCHW, labels)`` global batches, one per step); optionally
``variables`` (a ``torch.save`` of flax variables with numpy leaves,
loaded through ``ckpt/from_jax.py::rank_state_dict_from_flax``),
``resume`` (a one-process checkpoint to load before the steps), ``save``
(a directory to checkpoint into after the steps), ``eval`` (also run the
eval step on this rank's rows of the first batch). A case of ``kind``
``dropout`` instead returns the mask that a ``Dropout`` inside a layer
split over a model-only mesh of the world draws for this rank's block of
an activation (``shape`` the block's, split along ``dim``), from a
generator seeded with ``seed``.

A spec with ``main`` in place of ``cases`` runs the port's ``main`` once per
entry (``argv``), one run after another in the same processes, each with
its own rendezvous in its argv; an entry with ``world`` 1 runs on rank 0
alone, without torchrun's environment. ``main``'s throughput takes one
warmup and one timed forward there, not 50 and 30. ``rank<r>.pt`` then
holds, per run, ``main``'s result and what it printed (None on the ranks
that sat a run out).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import io
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ml_autofocusformermod_torch.ckpt import io as ckpt_io  # noqa: E402
from ml_autofocusformermod_torch.ckpt.from_jax import (  # noqa: E402
    rank_state_dict_from_flax,
)
from ml_autofocusformermod_torch.config import load_config  # noqa: E402
from ml_autofocusformermod_torch.models.build import build_model  # noqa: E402
from ml_autofocusformermod_torch.models.layers import Dropout  # noqa: E402
from ml_autofocusformermod_torch.parallel import mesh as mesh_lib  # noqa: E402
from ml_autofocusformermod_torch.parallel.zero import make_layout  # noqa: E402
from ml_autofocusformermod_torch.train.trainer import (  # noqa: E402
    create_train_state, make_eval_step, make_train_step, throughput,
)


def run_dropout(case: dict) -> dict:
    mesh = mesh_lib.make_mesh(1, torch.distributed.get_world_size())
    drop = Dropout(0.5).train()
    drop.generator = torch.Generator().manual_seed(case["seed"])
    x = torch.ones(case["shape"])
    return {"keep": drop(x, mesh.model_group, dim=case["dim"]) != 0}


def run_case(case: dict) -> dict:
    if case.get("kind") == "dropout":
        return run_dropout(case)
    config = load_config(case["cfg"], opts=case["opts"])
    mesh = mesh_lib.make_mesh(case["data"], case["model"])
    model = build_model(config, "cpu")
    layout = make_layout(model, mesh, case.get("zero1", False))
    if case.get("variables"):
        variables = torch.load(case["variables"], weights_only=False)
        model.load_state_dict(rank_state_dict_from_flax(
            variables, layout.tp, mesh.model_rank, mesh.model))
    state, schedule = create_train_state(config, model, 10, layout=layout)
    if case.get("resume"):
        ckpt_io.load_checkpoint(case["resume"], state)
    step = make_train_step(config, state, schedule)
    batches = torch.load(case["batches"], weights_only=False)
    out = {"metrics": []}
    for images, labels in batches:
        b = images.shape[0] // mesh.data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        m = step(images[rows].contiguous(), labels[rows].contiguous())
        out["metrics"].append({"loss": m["loss"].item(),
                               "grad_norm": m["grad_norm"].item(),
                               "finite": m["grads_finite"], "lr": m["lr"]})
    if case.get("eval"):
        images, labels = batches[0]
        b = images.shape[0] // mesh.data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        sums = make_eval_step(config, model)(images[rows], labels[rows])
        out["eval"] = {k: v.item() for k, v in sums.items()}
    payload = ckpt_io._payload(state, 0, 0.0)  # every rank gathers
    if mesh.rank == 0:
        out["full"] = payload["state"]
    out["blocks"] = {"model": {k: t.clone()
                               for k, t in model.state_dict().items()},
                     "optimizer": state.optimizer.state_dict(),
                     "ema": state.ema}
    out["coords"] = {"data_rank": mesh.data_rank,
                     "model_rank": mesh.model_rank}
    out["layout"] = {"tp": dict(layout.tp), "zero": dict(layout.zero)}
    if case.get("save"):
        ckpt_io.save_checkpoint(case["save"], 0, state, 0.0)
    mesh_lib.set_mesh(None)
    return out


TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def run_main(run: dict, rank: int):
    from ml_autofocusformermod_torch import main as port_main

    port_main.throughput = functools.partial(throughput, warmup=1, iters=1)
    if run.get("world") == 1 and rank != 0:
        return None
    saved = ({k: os.environ.pop(k) for k in TORCHRUN_ENV}
             if run.get("world") == 1 else {})
    gc.collect()  # the last run's loaders and state
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            result = port_main.main(run["argv"])
    finally:
        os.environ.update(saved)
    return {"result": result, "log": log.getvalue()}


def main(spec_path: str) -> None:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    if "main" in spec:
        results = [run_main(run, rank) for run in spec["main"]]
        torch.save(results, os.path.join(spec["out"], f"rank{rank}.pt"))
        return
    mesh_lib.init_distributed("cpu", "gloo", spec["init"])
    try:
        results = {case["name"]: run_case(case) for case in spec["cases"]}
        torch.save(results, os.path.join(spec["out"], f"rank{rank}.pt"))
    finally:
        mesh_lib.destroy()


def launch(tmp_dir: str, world: int, cases=None, timeout: float = 300,
           main_runs=None, env_extra=None) -> list:
    """Run ``cases`` (or, with ``main_runs``, those runs of ``main``) on
    ``world`` gloo ranks (one process each, a ``file://`` rendezvous in
    ``tmp_dir``) and return each rank's results, in rank order. Raises
    with the ranks' output when one fails."""
    os.makedirs(tmp_dir, exist_ok=True)
    spec = os.path.join(tmp_dir, "spec.json")
    with open(spec, "w") as f:
        json.dump({"init": "file://" + os.path.join(tmp_dir, "rendezvous"),
                   "out": tmp_dir, **({"main": main_runs} if main_runs
                                      else {"cases": cases})}, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), spec],
        env={**env, "RANK": str(r), "WORLD_SIZE": str(world),
             "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        raise RuntimeError("rank failed:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode})\n{log[-4000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


if __name__ == "__main__":
    main(sys.argv[1])
