"""Pipeline parallelism (``parallel/pp.py``, JAX ``parallel/pp.py``) in the
port (CPU, gloo ranks in subprocesses: ``torch_parallel_worker``, kind
``pipe``, one launch of two ranks and one of four).

* JAX ``tests/test_pp.py``'s chains (``x + tanh(x w + b) + consts``) at
  pipe 2 and 4 and data 2 x pipe 2, M in {2, 4, 8}, on the native
  point-to-point route and the all-reduce route that gloo takes on CUDA
  tensors: output within atol 1e-6 and gradients within rtol / atol 1e-4
  of JAX's ``pipeline_blocks`` on the virtual CPU mesh and of the port's
  ``sequential_blocks`` (JAX's own limits). In float64 on both sides: in
  float32 torch's and XLA's CPU matmul and tanh round differently, a few
  ulp per block, 1.7e-6 after eight blocks, where the schedule itself
  changes nothing (the port's pipelined output equals its sequential one
  to the bit);
* a tiny AFF stage-3 chain (dim 32, 2 heads, n = 64, clusters of 8, nnc
  4, 4 blocks, b 4; ``ClusterTransformerBlock`` on the fused attention,
  JAX's in interpret mode), the weights carried from JAX's stacked
  params through ``ckpt/from_jax.py::load_stacked_blocks``, each rank
  its stage only: output within 1e-5 and gradients within 1e-4 of
  max|ref|;
* the multi-chip dry run's toy (``eye(8) 0.5`` blocks, ``ones`` input, 4
  blocks at pipe 4): loss 916.7060, as ``MULTICHIP_r05.json`` has it;
* every rank issues the same collectives, and every pipe rank holds the
  same output;
* the hand-off (``comm.shift``) on both routes, bf16 included; bad shapes,
  a chain that draws randomness in training, a layout off the world, and
  stacked params with a missing or extra leaf are refused.
"""

import copy
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ml_autofocusformermod_torch.ckpt.from_jax import (load_stacked_blocks,
                                                       state_dict_from_flax)
from ml_autofocusformermod_torch.models import layers as tl
from ml_autofocusformermod_torch.ops.cluster_attention import tile_metadata
from ml_autofocusformermod_torch.parallel import pp
from ml_autofocusformermod_tpu.models import layers as jl
from ml_autofocusformermod_tpu.parallel import pp as jpp
from torch_parallel_worker import (ToyBlock, aff_block_fn, build_chain,
                                   chain_consts, chain_loss, launch,
                                   toy_block_fn)

torch.set_num_threads(1)
# the tiny AFF stage-3 chain
AFF = {"dim": 32, "heads": 2, "n": 64, "cs": 8, "nnc": 4, "blocks": 4,
       "b": 4, "rel_width": 15}
# name: (inputs, data, pipe, microbatches, grad, route)
CASES = {
    "toy_m/p2m4": ("toy_m", 1, 2, 4, False, None),
    "toy_m/p4m4": ("toy_m", 1, 4, 4, False, None),
    "toy_m/p4m8": ("toy_m", 1, 4, 8, False, None),
    "toy_c/d2p2m4": ("toy_c", 2, 2, 4, False, None),
    "toy_g/p2m2": ("toy_g", 1, 2, 2, True, None),
    "toy_g/p2m8_reduce": ("toy_g", 1, 2, 8, True, "reduce"),
    "toy_g/p4m8": ("toy_g", 1, 4, 8, True, None),
    "toy_g/d2p2m2_reduce": ("toy_g", 2, 2, 2, True, "reduce"),
    "aff/p2m2": ("aff", 1, 2, 2, True, None),
    "aff/p2m4_reduce": ("aff", 1, 2, 4, True, "reduce"),
    "aff/p4m4": ("aff", 1, 4, 4, True, None),
    "aff/d2p2m2_reduce": ("aff", 2, 2, 2, True, "reduce"),
    "dryrun/p4m4": ("dryrun", 1, 4, 4, True, None),
}
GRAD_CASES = [k for k, v in CASES.items() if v[4]]
# name: (world, dtype, route)
SHIFTS = {"shift/p2": (2, "float32", None),
          "shift/p2_reduce_bf16": (2, "bfloat16", "reduce"),
          "shift/p4_bf16": (4, "bfloat16", None)}


def _toy(rng, n_blocks, dim, batch, consts=False):
    """A toy chain's stacked ``w`` and ``b``, ``x`` and ``consts``, float64
    (JAX ``tests/test_pp.py::_make_params``'s scales)."""
    out = {"w": torch.from_numpy(rng.standard_normal((n_blocks, dim, dim))
                                 * 0.3),
           "b": torch.from_numpy(rng.standard_normal((n_blocks, dim)) * 0.1),
           "x": torch.from_numpy(rng.standard_normal((batch, dim)))}
    if consts:
        out["consts"] = [torch.from_numpy(rng.standard_normal((batch, dim)))]
    return out


def _jax_aff_block():
    return jl.ClusterTransformerBlock(dim=AFF["dim"], num_heads=AFF["heads"],
                                      use_pallas=True,
                                      rel_pos_width=AFF["rel_width"])


def _aff(rng):
    """The tiny AFF chain's inputs and stacked flax params (as
    ``tests/test_torch_layers.py`` draws a block's)."""
    b, n, cs, nnc, dim = (AFF[k] for k in ("b", "n", "cs", "nnc", "dim"))
    k = -(-n // cs)
    ncc = np.argsort(rng.uniform(size=(b, n, k)), -1)[:, :, :nnc].astype(
        np.int32)
    pos = rng.integers(0, AFF["rel_width"] + 1, (b, n, 2)).astype(np.float32)
    x = rng.standard_normal((b, n, dim)).astype(np.float32)
    member_idx = (ncc[..., None] * cs + np.arange(cs)).reshape(b, n, -1)
    jargs = (jnp.asarray(x), jnp.asarray(member_idx),
             jnp.asarray((member_idx < n).astype(np.int32)), False, None)
    shapes = jax.eval_shape(lambda: _jax_aff_block().init(
        jax.random.PRNGKey(0), *jargs, nearest_cluster=jnp.asarray(ncc),
        cluster_size=cs, pos=jnp.asarray(pos)))["params"]

    def draw(path, leaf):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(
            np.float32)

    stacked = jax.tree_util.tree_map(
        lambda *xs: np.stack(xs),
        *[jax.tree_util.tree_map_with_path(draw, shapes)
          for _ in range(AFF["blocks"])])
    return {"aff": AFF, "variables": {"params": stacked},
            "x": torch.from_numpy(x), "ncc": torch.from_numpy(ncc),
            "pos": torch.from_numpy(pos), "member_idx": member_idx,
            "g": torch.from_numpy(rng.standard_normal(x.shape).astype(
                np.float32))}


def _jax_toy_block(params, x, *consts):  # tests/test_pp.py::_block
    w, bias = params
    y = jnp.tanh(x @ w + bias)
    for c in consts:
        y = y + c
    return x + y


def _jax_run(name, inputs, pipe, M, grad, batch_spec=P()):
    """JAX's ``pipeline_blocks`` of ``inputs`` at ``pipe`` x (8 / pipe)
    data on the virtual CPU devices: the output and, with ``grad``, the
    loss and the gradients of the parameters (stacked) and of ``x``."""
    mesh = jpp.make_pipe_mesh(pipe, data=len(jax.devices()) // pipe)
    if name == "aff":
        params = inputs["variables"]["params"]
        ncc, n = inputs["ncc"].numpy(), AFF["n"]
        mi = inputs["member_idx"]
        consts = tuple(map(jnp.asarray, (mi, (mi < n).astype(np.int32), ncc,
                                         inputs["pos"].numpy())))

        def block(p, y, mi, mask, ncc, pos):
            return _jax_aff_block().apply(
                {"params": p}, y, mi, mask, False, None, nearest_cluster=ncc,
                cluster_size=AFF["cs"], pos=pos)
    else:
        params = (inputs["w"].numpy(), inputs["b"].numpy())
        consts = tuple(c.numpy() for c in inputs.get("consts", ()))
        block = _jax_toy_block

    def run(p, x):
        return jpp.pipeline_blocks(block, p, x, consts, mesh=mesh,
                                   num_microbatches=M, batch_spec=batch_spec)

    def loss(p, x):
        y = run(p, x)
        g = inputs.get("g")
        return jnp.sum(y * g.numpy() if g is not None else y * y), y

    with (jax.default_matmul_precision("highest"),
          jax.enable_x64(inputs["x"].dtype == torch.float64)):
        x = jnp.asarray(inputs["x"].numpy())
        if not grad:
            return {"out": np.asarray(jax.jit(run)(params, x))}
        (val, y), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, x)
    return {"out": np.asarray(y), "loss": float(val), "x_grad": np.asarray(gx),
            "grads": jax.tree_util.tree_map(np.asarray, gp)}


def _jax_block_grads(grads, inp):
    """JAX's stacked gradients by the port's ``<block>.<parameter>`` keys
    (``state_dict_from_flax`` of each block's slice for the AFF chain)."""
    if inp != "aff":
        return {f"{i}.{k}": g[i] for k, g in zip("wb", grads)
                for i in range(g.shape[0])}
    return {f"{i}.{k}": v for i in range(AFF["blocks"])
            for k, v in state_dict_from_flax({"params": jax.tree_util.
                                              tree_map(lambda a: a[i], grads)}
                                             ).items()}


def _port_sequential(inputs):
    """The port's ``sequential_blocks`` of the whole chain in this process:
    output, loss, ``x``'s gradient and every block's gradients."""
    chain, block_fn = build_chain(inputs)
    if "aff" in inputs:
        load_stacked_blocks(chain, inputs["variables"])
    x = inputs["x"].clone().requires_grad_()
    out = pp.sequential_blocks(block_fn, chain, x, chain_consts(inputs))
    loss = chain_loss(inputs, out)
    loss.backward()
    return {"out": out.detach(), "loss": loss.item(), "x_grad": x.grad,
            "grads": {f"{i}.{k}": p.grad for i, blk in enumerate(chain)
                      for k, p in blk.named_parameters()}}


@pytest.fixture(scope="module")
def aff_inputs():
    return _aff(np.random.default_rng(3))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel_pipe"))
    rng = np.random.default_rng(12)
    inputs = {
        # tests/test_pp.py:43, 59, 83
        "toy_m": _toy(rng, 8, 16, 32),
        "toy_c": _toy(rng, 4, 8, 16, consts=True),
        "toy_g": _toy(rng, 8, 8, 16),
        # __graft_entry__.py's pipeline dry run, in its float32
        "dryrun": {"w": torch.eye(8).expand(4, 8, 8) * 0.5,
                   "b": torch.full((4, 8), 0.01), "x": torch.ones(8, 8)},
        "aff": _aff(rng),
    }
    for name, value in inputs.items():
        torch.save(value, os.path.join(tmp, name + ".pt"))
    by_world = {2: [], 4: []}
    for name, (inp, data, pipe, M, grad, route) in CASES.items():
        by_world[data * pipe].append({
            "name": name, "kind": "pipe", "data": data, "pipe": pipe,
            "num_microbatches": M, "grad": grad, "route": route,
            "inputs": os.path.join(tmp, inp + ".pt")})
    for name, (world, dtype, route) in SHIFTS.items():
        by_world[world].append({"name": name, "kind": "shift",
                                "dtype": dtype, "route": route})
    with ThreadPoolExecutor(2) as pool:
        launches = {w: pool.submit(launch, os.path.join(tmp, f"w{w}"), w,
                                   cases)
                    for w, cases in by_world.items()}
        jax_refs = {
            "toy_m/4": _jax_run("toy_m", inputs["toy_m"], 4, 4, False),
            "toy_m/8": _jax_run("toy_m", inputs["toy_m"], 4, 8, False),
            "toy_c": _jax_run("toy_c", inputs["toy_c"], 4, 4, False,
                              P("data")),
            "toy_g": _jax_run("toy_g", inputs["toy_g"], 4, 8, True),
            "dryrun": _jax_run("dryrun", inputs["dryrun"], 4, 4, True,
                               P("data")),
            "aff": _jax_run("aff", inputs["aff"], 2, 2, True),
        }
        seq = {name: _port_sequential(value)
               for name, value in inputs.items()}
        ranks = {w: f.result() for w, f in launches.items()}
    return {"jax": jax_refs, "seq": seq, "ranks": ranks}


def _ranks(runs, name):
    for ranks in runs["ranks"].values():
        if name in ranks[0]:
            return [r[name] for r in ranks]
    raise KeyError(name)


def _jax_ref(runs, name):
    inp, _, _, M = CASES[name][:4]
    return runs["jax"][f"toy_m/{M}" if inp == "toy_m" else inp]


def _close(got, want, name, what, rel=None, atol=0.0, rtol=0.0):
    """``got`` within ``rel`` of max|want| (the AFF chain's limits), else
    within ``atol`` / ``rtol`` (JAX's own)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if rel is not None:
        atol, rtol = rel * np.abs(want).max(), 0.0
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                               err_msg=f"{name} {what}")


def _data_rows(ranks, key):
    """``key`` of every data rank (pipe rank 0's), in data-rank order."""
    return torch.cat([r[key] for r in sorted(
        (r for r in ranks if r["pipe_rank"] == 0),
        key=lambda r: r["data_rank"])])


@pytest.mark.parametrize("name", list(CASES))
def test_output_matches_jax_and_sequential(runs, name):
    """Every layout's output, assembled over the data ranks, equals JAX's
    pipelined output and the port's sequential chain; every pipe rank of a
    data rank holds the same output, bit for bit, and every rank issued
    as many collectives."""
    inp = CASES[name][0]
    ranks = _ranks(runs, name)
    got = _data_rows(ranks, "out")
    limits = dict(rel=1e-5) if inp == "aff" else dict(atol=1e-6)
    _close(got, _jax_ref(runs, name)["out"], name, "out vs JAX", **limits)
    _close(got, runs["seq"][inp]["out"], name, "out vs sequential", **limits)
    for r in ranks:
        twin = next(s for s in ranks if s["data_rank"] == r["data_rank"])
        assert torch.equal(r["out"], twin["out"])
    assert len({r["comm_calls"] for r in ranks}) == 1, [
        r["comm_calls"] for r in ranks]


@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradients_match_jax_and_sequential(runs, name):
    """``x``'s gradient (every pipe rank holds the whole of it) and every
    block's parameter gradients (on the block's own pipe rank, averaged
    over the data line, times the data size: each data rank's loss is its
    rows' sum) equal JAX's and the sequential chain's."""
    inp, data = CASES[name][:2]
    ranks = _ranks(runs, name)
    jax_ref, seq = _jax_ref(runs, name), runs["seq"][inp]
    limits = dict(rel=1e-4) if inp == "aff" else dict(atol=1e-4, rtol=1e-4)
    for r in ranks:
        twin = next(s for s in ranks if s["data_rank"] == r["data_rank"])
        assert torch.equal(r["x_grad"], twin["x_grad"])
    x_grad = _data_rows(ranks, "x_grad")
    _close(x_grad, jax_ref["x_grad"], name, "x grad vs JAX", **limits)
    _close(x_grad, seq["x_grad"], name, "x grad vs sequential", **limits)
    grads = {k: g * data for r in ranks for k, g in r["grads"].items()}
    assert sorted(grads) == sorted(seq["grads"])
    for key, want in seq["grads"].items():
        _close(grads[key], want, name, f"{key} vs sequential", **limits)
    for key, want in _jax_block_grads(jax_ref["grads"], inp).items():
        _close(grads[key], want, name, f"{key} vs JAX", **limits)


def test_dry_run_loss(runs):
    """The multi-chip dry run's pipeline toy in float32: every rank's loss
    is ``MULTICHIP_r05.json``'s ``dryrun pp: ok, mesh=(2 data x 4 pipe),
    loss=916.7060`` within 1e-6 relative, the float32 rounding of that run
    (the exact loss is 916.70563; JAX on the CPU gives 916.70551), and
    JAX's CPU loss within 1e-6 relative."""
    jax_loss = runs["jax"]["dryrun"]["loss"]
    assert jax_loss == pytest.approx(916.7060, rel=1e-6)
    for r in _ranks(runs, "dryrun/p4m4"):
        assert r["loss"] == pytest.approx(916.7060, rel=1e-6)
        assert r["loss"] == pytest.approx(jax_loss, rel=1e-6)


@pytest.mark.parametrize("name", list(SHIFTS))
def test_shift_hands_on_to_the_next_rank(runs, name):
    """``comm.shift``: each rank gets the previous rank's tensor, in its
    dtype, and the gradient of what it sent is the next rank's
    (``sum(got * (rank + 1))``: ``(rank + 1) % W + 1``)."""
    world, dtype, route = SHIFTS[name]
    _assert_shifted(_ranks(runs, name), world, dtype, route or "native")


def _assert_shifted(ranks, world, dtype, route):
    for r, res in enumerate(ranks):
        assert res["route"] == route
        assert res["got"].dtype == getattr(torch, dtype)
        assert torch.equal(res["got"].float(),
                           (r - 1) % world + torch.arange(3.0))
        assert torch.equal(res["grad"].float(),
                           torch.full((3,), (r + 1) % world + 1.0))


@pytest.mark.cuda
def test_shift_takes_the_reduce_route_on_the_card(tmp_path):
    """Two gloo ranks on the one card: ``comm.shift`` of CUDA tensors goes
    through the all-reduce route (gloo has no point-to-point for them),
    bf16 travelling as float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: gloo's CUDA tensors")
    ranks = launch(str(tmp_path), 2, [{"name": "shift", "kind": "shift",
                                       "dtype": "bfloat16",
                                       "device": "cuda"}])
    _assert_shifted([r["shift"] for r in ranks], 2, "bfloat16", "reduce")


# ------------------------------------------------ in one process ----

def _mesh(pipe, pipe_rank=0):
    """A rank's view of a pipe-only mesh, without process groups (for the
    checks that refuse before any collective)."""
    return pp.PipeMesh(1, pipe, pipe_rank, 0, pipe_rank)


def _toy_chain(n_blocks, dim, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return [ToyBlock(torch.randn(dim, dim, generator=g, dtype=dtype) * 0.3,
                     torch.randn(dim, generator=g, dtype=dtype) * 0.1)
            for _ in range(n_blocks)]


def test_stage_blocks_keeps_each_ranks_chunk():
    """Pipe rank ``p`` of ``P`` keeps blocks ``[p L / P, (p + 1) L / P)``;
    a chain that ``P`` does not divide is refused (JAX
    ``tests/test_pp.py:106``: 6 blocks over 4 stages)."""
    chain = list(range(8))
    assert [list(pp.stage_blocks(chain, _mesh(4, p))) for p in range(4)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    assert list(pp.stage_blocks(chain, _mesh(1))) == chain
    with pytest.raises(ValueError, match="not divisible"):
        pp.stage_blocks(list(range(6)), _mesh(4, 1))


def test_pipeline_rejects_bad_shapes():
    """A batch that the microbatches do not divide (JAX
    ``tests/test_pp.py:106``: 8 into 3), a const whose leading axis is
    neither the batch nor 1, a const that is no tensor, and a block that
    changes the hand-off's dtype are refused."""
    chain, x = _toy_chain(2, 4), torch.zeros(8, 4, dtype=torch.float64)
    run = functools.partial(pp.pipeline_blocks, toy_block_fn, chain, x,
                            mesh=_mesh(1))
    with pytest.raises(ValueError, match="not divisible"):
        run(num_microbatches=3)
    with pytest.raises(ValueError, match="leading axis"):
        run((torch.zeros(5, 4),), num_microbatches=2)
    with pytest.raises(TypeError, match="bind it"):
        run((3.0,), num_microbatches=2)
    with pytest.raises(ValueError, match="must keep"):
        pp.pipeline_blocks(lambda blk, y: y.float(), chain, x, mesh=_mesh(1),
                           num_microbatches=2)


def test_one_stage_runs_the_microbatches_in_turn():
    """At pipe 1 the schedule runs the chain on each microbatch in turn:
    the output, ``x``'s gradient and the blocks' gradients are the
    sequential chain's (a broadcast const of leading axis 1 and a per-row
    one)."""
    consts = (torch.randn(1, 6, dtype=torch.float64),
              torch.randn(8, 6, dtype=torch.float64))
    got = {}
    for name in ("seq", "pipe"):
        chain = _toy_chain(3, 6, seed=1)
        x = torch.linspace(-1, 1, 48, dtype=torch.float64).reshape(
            8, 6).requires_grad_()
        out = (pp.sequential_blocks(toy_block_fn, chain, x, consts)
               if name == "seq" else
               pp.pipeline_blocks(toy_block_fn, chain, x, consts,
                                  mesh=pp.make_pipe_mesh(1),
                                  num_microbatches=4))
        (out ** 2).sum().backward()
        got[name] = [out.detach(), x.grad] + [
            p.grad for blk in chain for p in blk.parameters()]
    for a, b in zip(got["pipe"], got["seq"], strict=True):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("rates", [
    {"drop": 0.1}, {"drop_path": 0.1}, {"attn_drop": 0.1}])
def test_pipeline_refuses_a_chain_that_draws(rates):
    """A chain with Dropout, DropPath or attention dropout above 0 in
    training mode is refused (the pipelined draws would not be the
    sequential chain's); in eval mode it runs."""
    blk = tl.ClusterTransformerBlock(16, 2, 2.0, 0.0, 7, **rates)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for t in blk.parameters():  # blank_k and blank_v start empty
            t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    b, n, cs = 2, 16, 8
    ncc = torch.tensor([[0, 1]] * 8 + [[1, 0]] * 8,
                       dtype=torch.int32).expand(b, n, 2)
    pos = torch.arange(2.0 * n).reshape(1, n, 2).expand(b, n, 2) % 7
    x = torch.randn(b, n, 16, generator=g)
    fn = aff_block_fn(cs)
    with pytest.raises(ValueError, match="draw randomness"):
        pp.pipeline_blocks(fn, [blk], x, (ncc, pos, tile_metadata(ncc)),
                           mesh=_mesh(1), num_microbatches=2)
    blk.eval()
    out = pp.pipeline_blocks(fn, [blk], x, (ncc, pos, tile_metadata(ncc)),
                             mesh=_mesh(1), num_microbatches=2)
    torch.testing.assert_close(out, fn(blk, x, ncc, pos, None), rtol=1e-6,
                               atol=1e-6)


def test_make_pipe_mesh_refuses_a_layout_off_the_world():
    """A layout whose sizes do not multiply to the ranks is refused (one
    process: a world of one)."""
    assert pp.make_pipe_mesh(1).pipe_group is None
    with pytest.raises(ValueError, match="ranks"):
        pp.make_pipe_mesh(2)
    with pytest.raises(ValueError, match="ranks"):
        pp.make_pipe_mesh(1, data=2)


@pytest.mark.parametrize("fault", ["missing", "extra", "lengths", "past"])
def test_load_stacked_blocks_is_strict(aff_inputs, fault):
    """Stacked params with a leaf that a block lacks, without one that it
    has, with leaves of different lengths, or shorter than the blocks
    asked for are refused."""
    variables = copy.deepcopy(aff_inputs["variables"])
    norm1 = variables["params"]["norm1"]
    first = 0
    if fault == "missing":
        del norm1["bias"]
    elif fault == "extra":
        norm1["offset"] = norm1["bias"]
    elif fault == "lengths":
        norm1["bias"] = norm1["bias"][:2]
    else:
        first = AFF["blocks"] - 1
    chain, _ = build_chain(aff_inputs)
    with pytest.raises(ValueError):
        load_stacked_blocks(chain[:2], variables, first)
