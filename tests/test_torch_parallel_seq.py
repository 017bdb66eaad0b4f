"""Sequence parallelism (``TPU.MESH_SEQ``, JAX ``parallel/mesh.py::
shard_tokens``) in the port, and the two repairs it rests on (CPU, gloo
ranks in subprocesses: ``torch_parallel_worker``, one launch of two ranks
and one of four).

* tiny AFF (``test_torch_parallel.py``'s ``TINY``) at seq 2, data 2 x seq
  2 and model 2 x seq 2, one step from JAX's weights against JAX's step on
  the matching virtual CPU mesh (built as ``tests/test_sp.py::_run_steps``
  builds it): loss and grad norm within 1e-4 relative;
* tiny Up-Down (``tests/test_maskfiner.py::tiny_mr``) at the same layouts,
  one step from JAX's weights with JAX's upsampling masks replayed: at seq
  2 against JAX's step on the seq-2 mesh; at data 2 x seq 2 and model 2 x
  seq 2 against JAX's one-device step, which JAX's mesh program is meant
  to compute but on the virtual CPU mesh does not (its gradients there
  differ from its own one-device ones; PERF.md section 7);
* two steps with mixup and DropPath (and, at data 1, Dropout and the
  attention kernels' dropout; at data 2 the kernels' dropout alone) at
  every layout, tiny OT at seq 2, and the collectives' all-reduce route
  (gloo on CUDA tensors), against the port's one-process steps of the
  global batch: loss and grad norm within 1e-5 relative, parameters,
  moments and EMA within rtol 1e-5 / atol 1e-7, with
  ``NOISE_GRADIENT_LEAVES`` as in ``test_torch_parallel.py``;
* C9: tiny UD with the attention kernels' dropout at data 2 x model 2;
* C10: two data ranks with Dropout, two steps against one step, a save, a
  resume and one more step, bit for bit;
* a seq-2 ZeRO-1 checkpoint loads in one process, and a one-process
  checkpoint resumes at seq 2;
* a token range whose boundary cuts a row of a MixResViT grid (the
  depthwise conv's halo);
* the plain attention over a query range against slices of the full call;
* ``check_switches`` accepts every mesh key.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from ml_autofocusformermod_torch.ckpt import io as ckpt_io
from ml_autofocusformermod_torch.config import load_config
from ml_autofocusformermod_torch.models.build import build_model, \
    check_switches
from ml_autofocusformermod_torch.models.mixres_vit import FeedForward
from ml_autofocusformermod_torch.ops import cluster_attention as ca
from ml_autofocusformermod_torch.parallel.mesh import token_range
from ml_autofocusformermod_torch.train import trainer
from ml_autofocusformermod_tpu.config import load_config as jax_load_config
from ml_autofocusformermod_tpu.parallel import mesh as jax_mesh
from ml_autofocusformermod_tpu.parallel import tp as jax_tp
from ml_autofocusformermod_tpu.train import trainer as jax_trainer
from test_torch_parallel import (JAX_CFG, MIX, PORT_CFG, TINY,
                                 _assert_state_close, _jax_model)
from torch_maskfiner_reference import (LABELS, TRAIN_MESH, run_reference,
                                       unflatten)
from torch_parallel_worker import launch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_DIR = os.path.join(ROOT, "ml_autofocusformermod_torch", "configs")
UD_CFG = os.path.join(CFG_DIR, "maskfiner_up_down_mini.yaml")
OT_CFG = os.path.join(CFG_DIR, "maskfiner_oracle_teacher.yaml")
AFF_BATCH, MR_BATCH = 8, 4
# name: (data, model, seq)
LAYOUTS = {"s2": (1, 1, 2), "d2s2": (2, 1, 2), "m2s2": (1, 2, 2)}
UD_MIX = {"TRAIN.USE_EMA": True, "AUG.MIXUP": 0.8, "AUG.CUTMIX": 1.0,
          "MODEL.MR.DROP_PATH_RATE": 0.1,
          "MODEL.MR.EMBED_DIM": [32, 24, 16, 16, 16, 24, 32],
          "MODEL.MR.ATTN_DROP_RATE": [0.0, 0.0, 0.2, 0.2, 0.2, 0.0, 0.0]}
# Dropout draws from a stream per data rank: at data 1 only
UD_DROP = {**UD_MIX, "MODEL.MR.DROP_RATE": [0.2] * 7}
OT_MIX = {k: v for k, v in UD_MIX.items() if "EMBED" not in k
          and "ATTN" not in k}
C10 = {"MODEL.DROP_RATE": 0.2, "MODEL.DROP_PATH_RATE": 0.1}
# the one-process runs the rank cases are held to: name -> (cfg, extra)
ONE = {"aff": (PORT_CFG, MIX), "ud_drop": (UD_CFG, UD_DROP),
       "ud_attn": (UD_CFG, UD_MIX), "ot": (OT_CFG, OT_MIX)}
# rank cases against the one-process runs: name -> (one, layout, zero1)
AGAINST_ONE = {
    "aff/s2": ("aff", "s2", False), "aff/d2s2": ("aff", "d2s2", True),
    "aff/m2s2": ("aff", "m2s2", False), "aff/s2_reduce": ("aff", "s2", False),
    "ud/s2": ("ud_drop", "s2", False), "ud/d2s2": ("ud_attn", "d2s2", False),
    "ud/m2s2": ("ud_drop", "m2s2", False), "ot/s2": ("ot", "s2", False),
    "ud/d2m2_attn": ("ud_attn", (2, 2, 1), False),
}


def _flat_opts(d):
    return [x for k, v in d.items()
            for x in (k, v if isinstance(v, str) else json.dumps(v))]


def _mr_tiny(cfg):
    n = 7 if cfg == UD_CFG else 4
    return {"MODEL.NUM_CLASSES": 10, "DATA.IMG_SIZE": 64,
            "TPU.COMPUTE_DTYPE": "float32",
            "MODEL.MR.EMBED_DIM": ([32, 24, 16, 8] + [16, 24, 32])[:n],
            "MODEL.MR.DEPTHS": [1] * n, "MODEL.MR.NUM_HEADS": [2] * n,
            "MODEL.MR.MLP_RATIO": [2.0] * n}


def _opts(cfg, layout=(1, 1, 1), batch=None, **extra):
    """The port opts of the tiny ``cfg`` at ``layout`` (data, model,
    seq), a global batch of ``batch`` split over the data ranks."""
    data, model, seq = layout
    base = dict(TINY) if cfg == PORT_CFG else _mr_tiny(cfg)
    batch = batch or (AFF_BATCH if cfg == PORT_CFG else MR_BATCH)
    return _flat_opts({**base, "DATA.BATCH_SIZE": batch // data,
                       "TPU.MESH_DATA": data, "TPU.MESH_MODEL": model,
                       "TPU.MESH_SEQ": seq, **extra})


def _layout(spec):
    return LAYOUTS[spec] if isinstance(spec, str) else spec


def _np_variables(rng, shapes):
    return jax.tree_util.tree_map(np.asarray, jax.tree_util.
                                  tree_map_with_path(
        lambda path, leaf: (
            rng.uniform(0.5, 1.5, leaf.shape) if path[-1].key == "var"
            else (path[-1].key == "scale") + 0.1 * rng.standard_normal(
                leaf.shape)).astype(np.float32), shapes))


def _jax_aff_steps(variables, images, labels):
    """JAX's AFF train step on each layout's virtual CPU mesh: (loss,
    grad norm)."""
    jmodel = _jax_model()
    cfg = jax_load_config(JAX_CFG, opts=_flat_opts(
        {**TINY, "DATA.BATCH_SIZE": AFF_BATCH}))
    out = {}
    for name, (data, model, seq) in LAYOUTS.items():
        state, tx, schedule = jax_trainer.create_train_state(
            cfg, jmodel, None, None, n_steps_per_epoch=10,
            variables=variables)
        mesh = jax_mesh.make_mesh(data=data, model=model, seq=seq,
                                  devices=jax.devices()[:data * model * seq])
        state = jax_tp.shard_tree(mesh, state)
        step = jax.jit(jax_trainer.make_train_step(cfg, jmodel, tx,
                                                   schedule))
        batch = jax_mesh.shard_batch(mesh, {"image": images,
                                            "label": labels})
        with mesh, jax.default_matmul_precision("highest"):
            _, m = step(state, batch, jax.random.PRNGKey(42))
        out[name] = (float(m["loss"]), float(m["grad_norm"]))
    return out


def _one_process(cfg, extra, batches, save=None):
    """The one-process steps of ``batches``; with ``save`` a checkpoint
    there after the first."""
    config = load_config(cfg, opts=_opts(cfg, **extra))
    state, schedule = trainer.create_train_state(
        config, build_model(config, "cpu"), 10)
    step = trainer.make_train_step(config, state, schedule)
    metrics = []
    for x, y in batches:
        m = step(x, y)
        metrics.append({"loss": m["loss"].item(),
                        "grad_norm": m["grad_norm"].item()})
        if save and len(metrics) == 1:
            ckpt_io.save_checkpoint(save, 0, state, 0.0)
    return {"metrics": metrics,
            "full": ckpt_io._payload(state, 0, 0.0)["state"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel_seq"))
    path = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    # JAX's Up-Down reference runs in processes of its own (XLA at
    # optimisation level 0), and both rank launches start as soon as the
    # one-process runs have written their checkpoint: JAX's AFF mesh steps
    # are computed here meanwhile, and the Up-Down cases come last in each
    # launch, waiting for their inputs (``ud_ready``)
    pool = ThreadPoolExecutor(3)
    ud_ref = pool.submit(run_reference, path(), ["ud_train"],
                         ["ud_train_s2"], devices=2)

    rng = np.random.default_rng(5)
    jmodel = _jax_model()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            np.zeros((1, 56, 56, 3), np.float32))
    variables = _np_variables(rng, shapes)
    torch.save(variables, path("aff_variables.pt"))
    aff = [(torch.from_numpy(rng.standard_normal((AFF_BATCH, 3, 56, 56))
                             .astype(np.float32)),
            torch.arange(AFF_BATCH) % 10) for _ in range(2)]
    mr = [(torch.from_numpy(rng.standard_normal((MR_BATCH, 3, 64, 64))
                            .astype(np.float32)),
           torch.arange(MR_BATCH) % 10) for _ in range(2)]
    torch.save(aff, path("aff.pt"))
    torch.save(aff[:1], path("aff1.pt"))
    torch.save(aff[1:], path("aff2.pt"))
    torch.save(mr, path("mr.pt"))
    one = {name: _one_process(cfg, extra, aff if cfg == PORT_CFG else mr,
                              save=path("one") if name == "aff" else None)
           for name, (cfg, extra) in ONE.items()}

    def case(name, cfg, layout, batches, extra=None, zero1=False, **kw):
        data, model, seq = _layout(layout)
        return {"name": name, "cfg": cfg,
                # the config's batch must divide by the data size: the
                # worker cuts the batches by the data size alone
                "opts": _opts(cfg, (data, model, seq),
                              batch=len(LABELS) * data if "ud1" in batches
                              else None, **(extra or {})),
                "data": data, "model": model, "seq": seq, "zero1": zero1,
                "batches": path(batches), **kw}

    cases = [case(f"aff/{name}/jax", PORT_CFG, spec, "aff1.pt",
                  variables=path("aff_variables.pt"))
             for name, spec in LAYOUTS.items()]
    for name, (ref, spec, zero1) in AGAINST_ONE.items():
        cfg, extra = ONE[ref]
        cases.append(case(name, cfg, spec, "aff.pt" if cfg == PORT_CFG
                          else "mr.pt", extra, zero1,
                          route="reduce" if name.endswith("reduce")
                          else None,
                          save=path("seq_zero") if name == "aff/d2s2"
                          else None))
    cases += [case("c10/two", PORT_CFG, (2, 1, 1), "aff.pt", C10),
              case("c10/one", PORT_CFG, (2, 1, 1), "aff1.pt", C10,
                   save=path("c10")),
              case("c10/resume", PORT_CFG, (2, 1, 1), "aff2.pt", C10,
                   resume=path("c10", "ckpt_epoch_0.pt")),
              case("aff/s2_resume", PORT_CFG, "s2", "aff2.pt", MIX,
                   resume=path("one", "ckpt_epoch_0.pt")),
              {"name": "halo", "kind": "halo", "grid": (3, 5), "seed": 4}]
    cases += [case(f"ud/{name}/jax", UD_CFG, spec, "ud1.pt",
                   variables=path("ud_variables.pt"),
                   masks=path("ud_masks.pt"), after=path("ud_ready"))
              for name, spec in LAYOUTS.items()]
    by_world = {2: [], 4: []}
    for c in cases:
        world = (c["data"] * c["model"] * c["seq"] if "data" in c else 2)
        by_world[world].append(c)
    launches = {w: pool.submit(launch, path(f"w{w}"), w, cs)
                for w, cs in by_world.items()}
    try:
        jax_aff = _jax_aff_steps(
            variables, np.ascontiguousarray(aff[0][0].numpy().transpose(
                0, 2, 3, 1)), aff[0][1].numpy())
        refs = ud_ref.result()
        torch.save({"params": unflatten(refs, "ud_train/params"),
                    "batch_stats": unflatten(refs, "ud_train/batch_stats")},
                   path("ud_variables.pt"))
        torch.save({int(k.rsplit("/", 1)[1]): torch.from_numpy(v)
                    for k, v in refs.items()
                    if k.startswith("ud_train/mask/")}, path("ud_masks.pt"))
        x = torch.from_numpy(refs["ud_train/in/x"]).permute(0, 3, 1, 2)
        torch.save([(x.contiguous(), torch.from_numpy(LABELS))],
                   path("ud1.pt"))
    finally:
        # also on a failure here, so that the ranks stop (on the inputs
        # that are missing) rather than wait
        open(path("ud_ready"), "w").close()
        ranks = {w: f.result() for w, f in launches.items()}
        pool.shutdown()
    return {"jax_aff": jax_aff, "refs": refs, "one": one, "ranks": ranks,
            "tmp": tmp}


def _ranks(runs, name):
    for world, ranks in runs["ranks"].items():
        if name in ranks[0]:
            return [r[name] for r in ranks]
    raise KeyError(name)


def _grad_norm(refs, case):
    return float(np.sqrt(sum(
        np.sum(refs[k].astype(np.float64) ** 2) for k in refs
        if k.startswith(f"{case}/grad/"))))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_aff_step_matches_jax_mesh_step(runs, name):
    """Tiny AFF's first step on every rank of each layout equals JAX's
    step on the matching mesh (rel 1e-4)."""
    loss, norm = runs["jax_aff"][name]
    for r in _ranks(runs, f"aff/{name}/jax"):
        m = r["metrics"][0]
        assert m["finite"]
        assert m["loss"] == pytest.approx(loss, rel=1e-4)
        assert m["grad_norm"] == pytest.approx(norm, rel=1e-4)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_ud_step_matches_jax(runs, name):
    """Tiny UD's first step from JAX's weights, JAX's masks replayed, on
    every rank: at seq 2 JAX's step on the seq-2 mesh; elsewhere JAX's
    one-device step (rel 1e-4). JAX's seq-2 mesh step is its one-device
    step."""
    refs = runs["refs"]
    case = "ud_train_s2" if name == "s2" else "ud_train"
    assert TRAIN_MESH["ud_train_s2"] == LAYOUTS["s2"]
    assert float(refs["ud_train_s2/out/loss"]) == pytest.approx(
        float(refs["ud_train/out/loss"]), rel=1e-6)
    assert _grad_norm(refs, "ud_train_s2") == pytest.approx(
        _grad_norm(refs, "ud_train"), rel=1e-5)
    for r in _ranks(runs, f"ud/{name}/jax"):
        m = r["metrics"][0]
        assert m["finite"]
        assert m["loss"] == pytest.approx(float(refs[f"{case}/out/loss"]),
                                          rel=1e-4)
        assert m["grad_norm"] == pytest.approx(_grad_norm(refs, case),
                                               rel=1e-4)


@pytest.mark.parametrize("name", list(AGAINST_ONE))
def test_two_steps_match_one_process(runs, name):
    """Two steps at each layout equal the one-process steps of the global
    batch: loss and grad norm (rel 1e-5) on every rank, and the gathered
    parameters, moments and EMA. Every rank ran collectives."""
    ref = runs["one"][AGAINST_ONE[name][0]]
    ranks = _ranks(runs, name)
    for r in ranks:
        assert r["comm_calls"] > 0
        for m, want in zip(r["metrics"], ref["metrics"], strict=True):
            assert m["finite"]
            assert m["loss"] == pytest.approx(want["loss"], rel=1e-5)
            assert m["grad_norm"] == pytest.approx(want["grad_norm"],
                                                   rel=1e-5)
    _assert_state_close(ranks[0]["full"], ref["full"], name,
                        [m["lr"] for m in ranks[0]["metrics"]])


def test_seq_ranks_hold_replicas(runs):
    """The seq ranks of a data rank end the steps with the same
    parameters, moments and EMA, bit for bit (ZeRO-1 cuts over data
    only)."""
    ranks = _ranks(runs, "aff/d2s2")
    by_data = {}
    for r in ranks:
        by_data.setdefault(r["coords"]["data_rank"], []).append(r)
    assert sorted(len(v) for v in by_data.values()) == [2, 2]
    for pair in by_data.values():
        assert {r["seq_rank"] for r in pair} == {0, 1}
        a, b = (r["blocks"] for r in pair)
        for k, t in a["model"].items():
            assert torch.equal(t, b["model"][k]), k
        for k, t in a["ema"].items():
            assert torch.equal(t, b["ema"][k]), k
        for k, t in a["optimizer"]["mu"].items():
            assert torch.equal(t, b["optimizer"]["mu"][k]), k


def test_seq_zero1_checkpoint_loads_in_one_process(runs):
    """The data 2 x seq 2 ZeRO-1 checkpoint (rank 0 speaks for its seq
    replica) loads into one process: the one-process state after the same
    two steps."""
    cfg = load_config(PORT_CFG, opts=_opts(PORT_CFG, **MIX))
    state, _ = trainer.create_train_state(cfg, build_model(cfg, "cpu"), 10)
    ckpt_io.load_checkpoint(os.path.join(runs["tmp"], "seq_zero",
                                         "ckpt_epoch_0.pt"), state)
    loaded = ckpt_io._payload(state, 0, 0.0)["state"]
    assert loaded["step"] == 2
    _assert_state_close(loaded, runs["one"]["aff"]["full"], "seq load",
                        [m["lr"] for m in _ranks(runs, "aff/d2s2")[0][
                            "metrics"]])


def test_one_process_checkpoint_resumes_at_seq_2(runs):
    """The one-process checkpoint after step 1 resumes on two seq ranks:
    their step 2 is the one-process step 2, and so is the state after
    it."""
    ref = runs["one"]["aff"]
    ranks = _ranks(runs, "aff/s2_resume")
    for r in ranks:
        (m,) = r["metrics"]
        assert m["loss"] == pytest.approx(ref["metrics"][1]["loss"],
                                          rel=1e-5)
        assert m["grad_norm"] == pytest.approx(
            ref["metrics"][1]["grad_norm"], rel=1e-5)
    _assert_state_close(ranks[0]["full"], ref["full"], "seq resume",
                        [m["lr"] for m in _ranks(runs, "aff/s2")[0][
                            "metrics"]])


def test_c10_resume_draws_the_uninterrupted_dropout(runs):
    """Two data ranks with Dropout: one step, a save, a resume and one more
    step give the parameters, moments and EMA of two steps, bit for bit
    (each data rank's Dropout stream is seeded from the step)."""
    two = _ranks(runs, "c10/two")[0]["full"]
    resumed = _ranks(runs, "c10/resume")[0]["full"]
    assert two["step"] == resumed["step"] == 2
    for part in ("model", "ema"):
        for k, t in two[part].items():
            assert torch.equal(t, resumed[part][k]), (part, k)
    for moment in ("mu", "nu"):
        for k, t in two["optimizer"][moment].items():
            assert torch.equal(t, resumed["optimizer"][moment][k]), k


def test_dwconv_halo_at_a_range_boundary_inside_a_grid_row(runs):
    """A 3 x 5 grid at seq 2: the first rank holds tokens [0, 7), so its
    last row is cut after column 2; each rank's output rows, and the mean
    over the ranks of every gradient (``parallel/__init__.py``'s rule),
    equal one process's."""
    ranks = _ranks(runs, "halo")
    assert [r["range"] for r in ranks] == [(0, 7), (7, 15)]
    torch.manual_seed(4)
    ffn = FeedForward(4, 6, dropout=0.0)
    x = torch.randn(2, 15, 4, requires_grad=True)
    weights = torch.randn(2, 15, 4)
    y = ffn(x, 3, 5)
    (y * weights).sum().backward()
    got = torch.cat([r["y"] for r in ranks], dim=1)
    torch.testing.assert_close(got, y.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sum(r["x_grad"] for r in ranks) / 2, x.grad,
                               rtol=1e-6, atol=1e-6)
    for k, p in ffn.named_parameters():
        torch.testing.assert_close(sum(r["grads"][k] for r in ranks) / 2,
                                   p.grad, rtol=1e-5, atol=1e-6)


# --------------------------------------------------- the query range ----

def _attention_inputs(n, cs, nnc, seed, b=2, h=2, c_=8):
    g = torch.Generator().manual_seed(seed)
    f64 = dict(dtype=torch.float64)
    c = h * c_
    k = -(-n // cs)
    return dict(
        q=torch.randn(b, n, c, generator=g, **f64),
        kv=torch.randn(b, n, 2 * c, generator=g, **f64),
        ncc=torch.randint(0, k, (b, n, nnc), generator=g,
                          dtype=torch.int32),
        pos=torch.rand(b, n, 2, generator=g) * 40,
        pe_kernel=torch.randn(5, h, generator=g, **f64),
        pe_bias=torch.randn(h, generator=g, **f64),
        blank_k=torch.randn(c_, h, generator=g, **f64),
        blank_v=torch.randn(h, c_, generator=g, **f64),
        g_out=torch.randn(b, n, c, generator=g, **f64))


@pytest.mark.parametrize("n,cs,cuts,clamp", [
    (1921, 8, (0, 960, 1921), 0),  # near-prime n, seq 2
    (1921, 8, (0, 1900, 1921), 0),  # a ragged end of 21 rows
    (203, 8, (0, 1, 101, 203), 15),  # a one-row range, the MixRes clamp
])
def test_plain_attention_over_a_query_range(n, cs, cuts, clamp):
    """The plain forward (output and statistics) and backward over each
    query range, with dropout, equal the rows of the full call; the
    ranges' dkv and small-parameter gradients sum to the full call's."""
    t = _attention_inputs(n, cs, 4, seed=n + len(cuts))
    args = (t["pe_kernel"], t["pe_bias"], t["blank_k"], t["blank_v"])
    drop = (0.2, 777)
    full, stats = ca.cluster_attention_reference(
        t["q"], t["kv"], t["ncc"], t["pos"], *args, 2, cs, 20, clamp,
        drop=drop, want_stats=True)
    grads = ca.cluster_attention_backward_reference(
        t["q"], t["kv"], t["ncc"], t["pos"], *args, t["g_out"], 2, cs, 20,
        clamp, saved=(full, stats), drop=drop)
    dkv, small = torch.zeros_like(t["kv"]), [0.0] * 4
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        rows = slice(lo, hi)
        out, st = ca.cluster_attention_reference(
            t["q"][:, rows], t["kv"], t["ncc"][:, rows], t["pos"], *args, 2,
            cs, 20, clamp, drop=drop, want_stats=True, q0=lo)
        torch.testing.assert_close(out, full[:, rows], rtol=0, atol=1e-12)
        torch.testing.assert_close(st, stats[:, rows], rtol=0, atol=1e-12)
        dq, dkv_r, *sm = ca.cluster_attention_backward_reference(
            t["q"][:, rows], t["kv"], t["ncc"][:, rows], t["pos"], *args,
            t["g_out"][:, rows], 2, cs, 20, clamp, saved=(out, st),
            drop=drop, q0=lo)
        torch.testing.assert_close(dq, grads[0][:, rows], rtol=0,
                                   atol=1e-10)
        dkv += dkv_r
        small = [a + b for a, b in zip(small, sm)]
    torch.testing.assert_close(dkv, grads[1], rtol=0, atol=1e-10)
    for got, want in zip(small, grads[2:]):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-9)


def test_op_takes_the_query_range():
    """``fused_cluster_attention`` with ``q0`` and its autograd: the
    range's output and the gradients it gives ``q`` and ``kv`` are the
    plain backward's of the range; a whole-range call is the plain call,
    bit for bit."""
    t = _attention_inputs(90, 8, 3, seed=9)
    args = (t["pe_kernel"], t["pe_bias"], t["blank_k"], t["blank_v"])
    whole = ca.fused_cluster_attention(t["q"], t["kv"], t["ncc"], t["pos"],
                                       *args, 2, 8, 20, q0=0)
    assert torch.equal(whole, ca.cluster_attention_reference(
        t["q"], t["kv"], t["ncc"], t["pos"], *args, 2, 8, 20))
    q = t["q"][:, 40:].clone().requires_grad_()
    kv = t["kv"].clone().requires_grad_()
    out = ca.fused_cluster_attention(q, kv, t["ncc"][:, 40:], t["pos"],
                                     *args, 2, 8, 20, q0=40)
    torch.testing.assert_close(out, whole[:, 40:], rtol=0, atol=1e-12)
    (out * t["g_out"][:, 40:]).sum().backward()
    dq, dkv, *_ = ca.cluster_attention_backward_reference(
        t["q"][:, 40:], t["kv"], t["ncc"][:, 40:], t["pos"], *args,
        t["g_out"][:, 40:], 2, 8, 20, q0=40)
    torch.testing.assert_close(q.grad, dq, rtol=0, atol=1e-10)
    torch.testing.assert_close(kv.grad, dkv, rtol=0, atol=1e-10)


def test_constant_tile_metadata_is_kept_per_range():
    """The on-grid stage's metadata is cached per tensor and range: each
    range's is the metadata of its rows."""
    ncc = torch.randint(0, 20, (150, 4), dtype=torch.int32)
    whole = ca.constant_tile_metadata(ncc)
    part = ca.constant_tile_metadata(ncc, 70, 150)
    assert ca.constant_tile_metadata(ncc, 70, 150) is part
    assert whole is ca.constant_tile_metadata(ncc, 0, 150)
    for got, want in zip(part, ca.tile_metadata(ncc[None, 70:])):
        assert torch.equal(got, want)


def test_token_ranges_cover_the_tokens():
    """The seq ranks' ranges are contiguous, in rank order, cover every
    token once and differ in size by at most one."""
    for n in (1, 3, 49, 196, 1921, 3136):
        for seq in (1, 2, 3, 4):
            ranges = [token_range(n, seq, s) for s in range(seq)]
            assert ranges[0][0] == 0 and ranges[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            sizes = [hi - lo for lo, hi in ranges]
            assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("world,layout", [
    (2, (1, 1, 2)), (4, (2, 1, 2)), (4, (1, 2, 2)), (8, (2, 2, 2)),
    (4, (-1, 1, 2)), (8, (-1, 2, 2))])
def test_check_switches_accepts_every_mesh_key(world, layout):
    """Every mesh key is honoured, ``TPU.MESH_SEQ`` among them: a layout
    whose sizes multiply to the processes passes, one that does not
    raises."""
    data, model, seq = layout
    opts = ["TPU.MESH_DATA", str(data), "TPU.MESH_MODEL", str(model),
            "TPU.MESH_SEQ", str(seq), "TPU.ZERO1", "True"]
    config = load_config(PORT_CFG, opts=_flat_opts(TINY) + opts)
    check_switches(config, "cpu", world)
    with pytest.raises(ValueError, match="processes"):
        check_switches(config, "cpu", world * 2 + 1)
