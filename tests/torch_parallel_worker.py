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
``data``, ``model``, ``zero1`` and optionally ``seq`` (default 1);
``batches`` (a ``torch.save`` of a list of ``(images NCHW, labels)``
global batches, one per step); optionally ``variables`` (a ``torch.save``
of flax variables with numpy leaves, loaded through
``ckpt/from_jax.py::rank_state_dict_from_flax``), ``masks`` (a
``torch.save`` of ``{j: (global batch, n)}`` upsampling scores that a
MaskFiner model takes in place of its own draws, this data rank's rows),
``route`` (``reduce``: the collectives take the all-reduce route that
gloo on CUDA tensors takes), ``after`` (a file whose appearance says
that the case's inputs are written: the rank waits for it, so that a
launch can start before its last cases' inputs exist), ``resume`` (a
checkpoint to load before the steps), ``save`` (a directory to
checkpoint into after the steps; every rank waits for the write),
``eval`` (also run the eval step on this rank's rows of the first
batch). A case of ``kind`` ``dropout`` instead returns
the mask that a ``Dropout`` inside a layer split over a model-only mesh of
the world draws for this rank's block of an activation (``shape`` the
block's, split along ``dim``), from a generator seeded with ``seed``; of
``kind`` ``halo``, a MixResViT ``FeedForward`` (depthwise conv) on a
``(h, w)`` token grid at ``seq`` = the world, its output rows and the
gradients of a loss of the gathered output (:func:`run_halo`); of
``kind`` ``pipe``, a block chain pipelined over a ``(data, pipe)`` mesh
(``parallel/pp.py``, :func:`run_pipe`); of ``kind`` ``shift``, the pipe
hand-off alone (:func:`run_shift`).

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
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ml_autofocusformermod_torch.ckpt import io as ckpt_io  # noqa: E402
from ml_autofocusformermod_torch.ckpt.from_jax import (  # noqa: E402
    load_stacked_blocks, rank_state_dict_from_flax,
)
from ml_autofocusformermod_torch.config import load_config  # noqa: E402
from ml_autofocusformermod_torch.models.build import build_model  # noqa: E402
from ml_autofocusformermod_torch.models import (  # noqa: E402
    maskfiner_ot, maskfiner_ud,
)
from ml_autofocusformermod_torch.models.layers import (  # noqa: E402
    ClusterTransformerBlock, Dropout,
)
from ml_autofocusformermod_torch.models.mixres_vit import (  # noqa: E402
    FeedForward,
)
from ml_autofocusformermod_torch.ops.cluster_attention import (  # noqa: E402
    tile_metadata,
)
from ml_autofocusformermod_torch.parallel import comm  # noqa: E402
from ml_autofocusformermod_torch.parallel import mesh as mesh_lib  # noqa: E402
from ml_autofocusformermod_torch.parallel import pp  # noqa: E402
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


def run_halo(case: dict) -> dict:
    """This seq rank's rows of a depthwise-conv FeedForward's output on a
    ``(h, w)`` grid whose token range boundary cuts a grid row, and the
    gradients of ``sum(gathered output * weights)`` with respect to the
    whole input and the parameters."""
    mesh = mesh_lib.make_mesh(1, 1, torch.distributed.get_world_size())
    mesh_lib.set_mesh(mesh)
    torch.manual_seed(case["seed"])
    h, w = case["grid"]
    ffn = FeedForward(4, 6, dropout=0.0)
    x = torch.randn(2, h * w, 4, requires_grad=True)
    weights = torch.randn(2, h * w, 4)
    tokens = comm.token_range_of(h * w)
    y = ffn(comm.slice_tokens(x, tokens), h, w, tokens)
    (comm.gather_tokens(y, tokens) * weights).sum().backward()
    mesh_lib.set_mesh(None)
    return {"range": (tokens.lo, tokens.hi), "y": y.detach(),
            "x_grad": x.grad,
            "grads": {k: p.grad for k, p in ffn.named_parameters()}}


class ToyBlock(torch.nn.Module):
    """JAX ``tests/test_pp.py::_block``'s parameters: ``w`` (dim, dim) and
    ``b`` (dim,)."""

    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(w).clone())
        self.b = torch.nn.Parameter(torch.as_tensor(b).clone())


def toy_block_fn(blk, x, *consts):
    """JAX ``tests/test_pp.py::_block``: ``x + tanh(x w + b) + sum(consts)``."""
    y = torch.tanh(x @ blk.w + blk.b)
    for c in consts:
        y = y + c
    return x + y


def aff_block_fn(cs):
    """A local-attention ``ClusterTransformerBlock`` over the consts
    ``(ncc, pos, tile_meta)``, clusters of ``cs``."""
    def fn(blk, x, ncc, pos, meta):
        return blk(x, False, None, ncc, cs, pos, meta)
    return fn


def build_chain(inputs: dict):
    """``(blocks, block_fn)`` of a pipe case's inputs: ``toy`` blocks from
    the stacked ``w`` and ``b``, or AFF blocks (``aff``: dim, heads,
    rel_width, cs) with no weights loaded."""
    if "aff" in inputs:
        a = inputs["aff"]
        return ([ClusterTransformerBlock(a["dim"], a["heads"], 2.0, 0.0,
                                         a["rel_width"])
                 for _ in range(a["blocks"])], aff_block_fn(a["cs"]))
    return ([ToyBlock(w, b) for w, b in zip(inputs["w"], inputs["b"])],
            toy_block_fn)


def chain_consts(inputs: dict, rows=slice(None)):
    """The chain's consts on the batch ``rows``: the toy's ``c``, or the
    AFF chain's ``(ncc, pos, tile_metadata(ncc))``."""
    if "aff" in inputs:
        ncc = inputs["ncc"][rows].contiguous()
        return (ncc, inputs["pos"][rows].contiguous(), tile_metadata(ncc))
    return tuple(c[rows].contiguous() for c in inputs.get("consts", ()))


def chain_loss(inputs: dict, out, rows=slice(None)):
    """``sum(out * g)`` with the inputs' ``g``, else ``sum(out ** 2)``."""
    if "g" in inputs:
        return (out * inputs["g"][rows]).sum()
    return (out ** 2).sum()


def run_pipe(case: dict) -> dict:
    """This rank's part of a chain pipelined over a ``(data, pipe)`` mesh:
    its stage of the blocks (the AFF chain's loaded from the stacked flax
    variables through ``load_stacked_blocks``), on this data rank's rows
    of the inputs in ``num_microbatches`` microbatches; the output, and
    with ``grad`` the loss, ``x``'s gradient and the stage's parameter
    gradients by global block index, averaged over the data line."""
    mesh = pp.make_pipe_mesh(case["pipe"], case["data"])
    inputs = torch.load(case["inputs"], weights_only=False)
    chain, block_fn = build_chain(inputs)
    stage = pp.stage_blocks(chain, mesh)
    first = mesh.pipe_rank * len(stage)
    if "aff" in inputs:
        load_stacked_blocks(stage, inputs["variables"], first)
    b = inputs["x"].shape[0] // mesh.data
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    x = inputs["x"][rows].clone().requires_grad_(case.get("grad", False))
    calls = comm.STATS["calls"]
    out = pp.pipeline_blocks(block_fn, stage, x, chain_consts(inputs, rows),
                             mesh=mesh,
                             num_microbatches=case["num_microbatches"])
    res = {"out": out.detach().clone(), "pipe_rank": mesh.pipe_rank,
           "data_rank": mesh.data_rank}
    if case.get("grad"):
        loss = chain_loss(inputs, out, rows)
        loss.backward()
        params = {f"{first + j}.{k}": p for j, blk in enumerate(stage)
                  for k, p in blk.named_parameters()}
        comm.all_reduce_mean_([p.grad for p in params.values()],
                              mesh.data_group)
        res.update(loss=loss.item(), x_grad=x.grad,
                   grads={k: p.grad for k, p in params.items()})
    res["comm_calls"] = comm.STATS["calls"] - calls
    return res


def run_shift(case: dict) -> dict:
    """``comm.shift`` over the world in ``dtype`` on ``device`` (default
    the CPU): what each rank got for its ``rank + arange(3)``, the
    gradient of ``sum(got * (rank + 1))`` on what it sent, and the route
    the collectives took."""
    mesh = pp.make_pipe_mesh(torch.distributed.get_world_size())
    device = torch.device(case.get("device", "cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(0)
    dtype = getattr(torch, case.get("dtype", "float32"))
    x = (mesh.rank + torch.arange(3.0)).to(device, dtype).requires_grad_()
    got = comm.shift(x, mesh.pipe_group)
    (got.float() * (mesh.rank + 1)).sum().backward()
    return {"got": got.detach().cpu(), "grad": x.grad.cpu(),
            "route": comm._route(mesh.pipe_group, x)}


def _replay_masks(path, data_rank):
    """A ``random_upsampling_mask`` that returns this data rank's rows of
    the recorded scores."""
    masks = torch.load(path, weights_only=False)

    def replay(model, j, b, n, device):
        return masks[j][data_rank * b:(data_rank + 1) * b].to(device)

    return replay


def _wait_for(path: str, timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.1)


KINDS = {"dropout": run_dropout, "halo": run_halo, "pipe": run_pipe,
         "shift": run_shift}


def run_case(case: dict) -> dict:
    if case.get("after"):
        _wait_for(case["after"])
    with contextlib.ExitStack() as stack:
        if case.get("route"):
            stack.enter_context(_patched(comm, "_route",
                                         lambda group, t: case["route"]))
        if case.get("kind"):
            return KINDS[case["kind"]](case)
        return _run_steps(case, stack)


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _run_steps(case: dict, stack: contextlib.ExitStack) -> dict:
    config = load_config(case["cfg"], opts=case["opts"])
    mesh = mesh_lib.make_mesh(case["data"], case["model"],
                              case.get("seq", 1))
    model = build_model(config, "cpu")
    layout = make_layout(model, mesh, case.get("zero1", False))
    if case.get("variables"):
        variables = torch.load(case["variables"], weights_only=False)
        model.load_state_dict(rank_state_dict_from_flax(
            variables, layout.tp, mesh.model_rank, mesh.model))
    if case.get("masks"):
        replay = _replay_masks(case["masks"], mesh.data_rank)
        for module in (maskfiner_ot, maskfiner_ud):
            stack.enter_context(_patched(module, "random_upsampling_mask",
                                         replay))
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
    out["comm_calls"] = comm.STATS["calls"]
    out["coords"] = {"data_rank": mesh.data_rank,
                     "model_rank": mesh.model_rank}
    out["seq_rank"] = mesh.seq_rank
    out["layout"] = {"tp": dict(layout.tp), "zero": dict(layout.zero)}
    if case.get("save"):
        ckpt_io.save_checkpoint(case["save"], 0, state, 0.0)
        torch.distributed.barrier()
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
