"""The attention op's two modes against the JAX package (CPU): attention
dropout inside the kernels and the saved-stats backward.

* ``drop_keep`` against JAX ``clusten_pallas._drop_keep``, bit for bit;
* ``fused_cluster_attention(drop_rate, drop_seed)``: forward and every
  gradient against JAX's ``_fca_drop`` (Pallas forward and backward in
  interpret mode) with the same seed, fp32, within 1e-5 of each output's
  largest entry; one flipped mask bit breaks that limit. d_pe_kernel and
  d_pe_bias, sums of slot terms that cancel, are held to 1e-5 of the f64
  plain backward and to JAX within ``test_torch_grad``'s envelope for
  them (JAX's f32 sum of the slots' terms is itself ~2e-5 off at these
  shapes);
* the saved-stats mode: the plain forward's statistics against JAX
  ``_attention_fwd_impl(want_stats=True)`` and the saved backward against
  JAX's saved backward (``jax.vjp`` with ``MLAFF_BWD_SAVED=1``) on its
  windowed and stacked routes; against the port's own recompute backward,
  which ``MLAFF_BWD_SAVED=0`` selects.

The tests marked ``cuda`` hold the kernels' stats, saved backward and
dropout against the plain versions and check that the saved and the
dropout backward are bitwise reproducible; they skip without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_autofocusformermod_torch.ops import cluster_attention as ops
from ml_autofocusformermod_torch.ops.cluster_attention import (
    cluster_attention_backward, cluster_attention_backward_reference,
    cluster_attention_forward, cluster_attention_reference, drop_keep,
    fused_cluster_attention,
)
from ml_autofocusformermod_tpu.ops import clusten_pallas as cp

torch.set_num_threads(1)
ARGS = ["q", "kv", "ncc", "pos", "pe_kernel", "pe_bias", "blank_k",
        "blank_v"]
GRADS = ["q", "kv", "pe_kernel", "pe_bias", "blank_k", "blank_v"]
REL = 1e-5  # of each output's largest entry
CS = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(seed, b, n, nnc, hw, h, c_, grid=None):
    """Attention inputs (numpy): random distinct nearest clusters and
    positions, or ``grid = (pos (n, 2), ncc (n, nnc))`` broadcast."""
    rng = np.random.default_rng(seed)
    if grid is None:
        k = -(-n // CS)
        ncc = np.argsort(rng.uniform(size=(b, n, k)), -1)[:, :, :nnc]
        pos = rng.integers(0, hw, size=(b, n, 2)).astype(np.float32)
    else:
        pos = np.broadcast_to(grid[0][None], (b, n, 2))
        ncc = np.broadcast_to(grid[1][None], (b, n, nnc))
    c = h * c_
    return dict(
        q=rng.standard_normal((b, n, c)).astype(np.float32) * c_**-0.5,
        kv=rng.standard_normal((b, n, 2 * c)).astype(np.float32),
        ncc=np.ascontiguousarray(ncc, np.int32),
        pos=np.ascontiguousarray(pos, np.float32),
        pe_kernel=(rng.standard_normal((5, h)) * 0.1).astype(np.float32),
        pe_bias=(rng.standard_normal((h,)) * 0.1).astype(np.float32),
        blank_k=(rng.standard_normal((c_, h)) * 0.5).astype(np.float32),
        blank_v=(rng.standard_normal((h, c_)) * 0.5).astype(np.float32),
        g=rng.standard_normal((b, n, c)).astype(np.float32),
    )


def _jax_vjp(a, geo, **kw):
    """JAX ``fused_cluster_attention``: out and the gradients of GRADS."""
    h, cs, R, clamp = geo
    ncc, pos = jnp.asarray(a["ncc"]), jnp.asarray(a["pos"])

    def f(q, kv, pk, pb, bk, bv):
        return cp.fused_cluster_attention(q, kv, ncc, pos, pk, pb, bk, bv, h,
                                          cs, R, clamp, **kw)

    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(f, *(jnp.asarray(a[k]) for k in GRADS))
        grads = vjp(jnp.asarray(a["g"]))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _port_vjp(a, geo, **kw):
    """The port's out and gradients of GRADS, through autograd (CPU)."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    for k in GRADS:
        t[k].requires_grad_(True)
    out = fused_cluster_attention(*(t[k] for k in ARGS), *geo, **kw)
    out.backward(t["g"])
    return [out.detach().numpy()] + [t[k].grad.numpy() for k in GRADS]


def _worst(got, want):
    """The largest error of any output over its largest entry."""
    return max(np.abs(x - y).max() / np.abs(y).max()
               for x, y in zip(got, want))


PE = (3, 4)  # the d_pe_kernel and d_pe_bias entries of a _jax_vjp list


def _assert_matches(got, want, exact):
    """out and the gradients within REL of JAX's; d_pe_kernel and
    d_pe_bias within REL of ``exact`` (the f64 plain backward's) and
    within ``test_torch_grad``'s envelope of JAX's."""
    strict = [i for i in range(len(got)) if i not in PE]
    assert _worst([got[i] for i in strict], [want[i] for i in strict]) <= REL
    assert _worst([got[i] for i in PE], [exact[i - 1] for i in PE]) <= REL
    for i in PE:
        np.testing.assert_allclose(
            got[i], want[i], rtol=1e-4,
            atol=1e-5 + 1e-6 * np.abs(want[i]).max())


def _exact(a, geo, drop=None):
    """The gradients of the f64 plain backward (recompute)."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).double()
         if v.dtype == np.float32 else torch.from_numpy(v)
         for k, v in a.items()}
    grads = cluster_attention_backward_reference(
        *(t[k] for k in ARGS), t["g"], *geo, drop=drop)
    return [g.numpy() for g in grads]


# ------------------------------------------------------------ the hash ----

@pytest.mark.parametrize("seed", [0, 1, 2**31 - 2])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_drop_keep_matches_jax_bit_for_bit(seed, rate):
    """Images 0 and 5, heads 0 and 3, a plane of rows past 2^16 whose
    columns reach 65535 (the blank's), and the first rows of a plane."""
    dropped = []
    for img in (0, 5):
        for head in (0, 3):
            for row0, col0, rows, cols in ((65536 + 70, 65400, 6, 136),
                                           (0, 0, 64, 96),
                                           (3 * 65536 + 1, 65535, 5, 1)):
                want = np.asarray(cp._drop_keep(
                    jnp.int32(seed), jnp.int32(img), head, row0, col0, rows,
                    cols, rate))
                got = drop_keep(seed, img, head,
                                torch.arange(rows)[:, None] + row0,
                                torch.arange(cols)[None] + col0, rate)
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), want)
                dropped.append((want == 0).ravel())
    share = np.concatenate(dropped).mean()
    assert abs(share - rate) < 0.05


# -------------------------------------------------------- the dropout ----

# (seed, b, n, nnc, hw, h, c_, R, clamp): an AFF-like stage (c_ = 8, a
# padded last cluster) and a MixRes level with the rel-pos clamp
DROP_SHAPES = {
    "aff_c8": ((21, 2, 52, 3, 12, 2, 8), (2, CS, 5, 0)),
    "mixres_clamp": ((22, 2, 100, 4, 30, 2, 16), (2, CS, 511, 1023)),
}


@pytest.mark.parametrize("name", list(DROP_SHAPES))
def test_dropout_matches_jax(name):
    """Forward and every gradient of ``drop_rate=0.25`` with one seed,
    the port's saved-stats backward against JAX's dropout backward."""
    shape, geo = DROP_SHAPES[name]
    a = _case(*shape)
    seed = 918273645
    want = _jax_vjp(a, geo, drop_rate=0.25,
                    drop_seed=jnp.array([seed], jnp.int32))
    got = _port_vjp(a, geo, drop_rate=0.25, drop_seed=seed)
    _assert_matches(got, want, _exact(a, geo, (0.25, seed)))
    # the masks do drop: without them the outputs differ
    assert _worst(_port_vjp(a, geo), want) > 100 * REL


def test_one_flipped_mask_bit_breaks_the_dropout_limit(monkeypatch):
    """The sensitivity of :func:`test_dropout_matches_jax`: one (image,
    head, query, slot) of the port's mask flipped moves an output by far
    more than the limit."""
    shape, geo = DROP_SHAPES["aff_c8"]
    a = _case(*shape)
    seed = 918273645
    want = _jax_vjp(a, geo, drop_rate=0.25,
                    drop_seed=jnp.array([seed], jnp.int32))
    real = ops.drop_keep

    def flipped(seed_, img, head, rows, cols, rate):
        keep = real(seed_, img, head, rows, cols, rate)
        if keep.dim() == 4 and keep.shape[-1] > 1:  # the slots' plane
            keep = keep.clone()
            keep[1, 1, 7, 5] = 0.0 if keep[1, 1, 7, 5] else 1 / 0.75
        return keep

    monkeypatch.setattr(ops, "drop_keep", flipped)
    got = _port_vjp(a, geo, drop_rate=0.25, drop_seed=seed)
    assert _worst(got[:3], want[:3]) > 100 * REL  # out, dq, dkv


def test_dropout_needs_a_seed_and_heads_of_eight_channels():
    """As JAX's ``fused_cluster_attention`` asserts: a seed with every
    rate above 0, and c_ % 8 == 0."""
    a = _case(*DROP_SHAPES["aff_c8"][0])
    t = [torch.from_numpy(a[k]) for k in ARGS]
    with pytest.raises(ValueError, match="drop_seed"):
        fused_cluster_attention(*t, *DROP_SHAPES["aff_c8"][1],
                                drop_rate=0.1)
    narrow = _case(23, 2, 52, 3, 12, 2, 4)
    t = [torch.from_numpy(narrow[k]) for k in ARGS]
    with pytest.raises(ValueError, match="c_ % 8"):
        fused_cluster_attention(*t, *DROP_SHAPES["aff_c8"][1],
                                drop_rate=0.1, drop_seed=3)


# ---------------------------------------------------- the saved stats ----

def _windowed(monkeypatch, b=2):
    """AFF's on-grid stage at 16 x 16 (cs 8, nnc 3, h 2, c_ 16) with
    host-constant neighbours, JAX forced onto its windowed route (as
    ``tests/test_route_lattice.py::test_wstack_saved_bwd_matches_recompute``
    does in interpret mode): (numpy case, JAX kwargs)."""
    from ml_autofocusformermod_tpu.ops.sfc import (
        grid_cluster, grid_nearest_clusters,
    )

    hw, nnc, tq = 16, 3, 64
    n = hw * hw
    g_pos = grid_cluster(hw, hw, CS)[0]
    g_ncc = grid_nearest_clusters(hw, hw, CS, nnc)
    monkeypatch.setenv("MLAFF_WFRAC", "1.0")
    monkeypatch.setenv("MLAFF_STACK", "0")
    win = cp._static_window(g_ncc, n, tq, CS, n)
    real = cp._choose_tiling

    def forced(n_, np_, cs_, sn):
        if sn is not None and n_ == n:
            return tq, win
        return real(n_, np_, cs_, sn)

    monkeypatch.setattr(cp, "_choose_tiling", forced)
    a = _case(31, b, n, nnc, hw, 2, 16, grid=(g_pos, g_ncc))
    return a, dict(static_ncc=g_ncc, static_pos=g_pos)


def _stacked(monkeypatch):
    """n = 196 with random neighbours on JAX's stacked route, its saved
    backward forced below its size floor (``MLAFF_BWD_SAVED_NMIN=0``)."""
    monkeypatch.setenv("MLAFF_STACK", "1")
    monkeypatch.setenv("MLAFF_BWD_SAVED_NMIN", "0")
    assert cp._route(196, 200, CS, None, None, bwd=True).stacked
    return _case(32, 2, 196, 4, 28, 2, 16), {}


ROUTES = {"windowed": _windowed, "stacked": _stacked}


@pytest.mark.parametrize("route", list(ROUTES))
def test_plain_stats_match_jax(route, monkeypatch):
    """The per-row max (lane hi) and denominator (lane h + hi) of the
    plain forward against those JAX's forward kernel writes."""
    a, kw = ROUTES[route](monkeypatch)
    wrapped = (cp._StaticNcc(kw["static_ncc"], kw["static_pos"])
               if kw else None)
    with jax.default_matmul_precision("highest"):
        out, stats = cp._attention_fwd_impl(
            *(jnp.asarray(a[k]) for k in ARGS), 2, CS, 55, 0, wrapped,
            want_stats=True)
    assert stats is not None
    t = [torch.from_numpy(a[k]) for k in ARGS]
    got_out, got = cluster_attention_reference(*t, 2, CS, 55,
                                               want_stats=True)
    assert got.shape == stats.shape == (2, a["q"].shape[1], 4)
    assert _worst([got_out.numpy(), got.numpy()],
                  [np.asarray(out), np.asarray(stats)]) <= REL


@pytest.mark.parametrize("route", list(ROUTES))
def test_saved_backward_matches_jax_saved_backward(route, monkeypatch):
    """Every gradient of the port's saved-stats backward against JAX's
    (its Pallas backward in interpret mode, which took the saved
    residuals)."""
    a, kw = ROUTES[route](monkeypatch)
    monkeypatch.setenv("MLAFF_PALLAS_BWD_INTERPRET", "1")
    monkeypatch.setenv("MLAFF_BWD_SAVED", "1")
    took = []
    real = cp._attention_bwd_impl

    def recording(*args, saved=None, **kws):
        took.append(saved is not None)
        return real(*args, saved=saved, **kws)

    monkeypatch.setattr(cp, "_attention_bwd_impl", recording)
    want = _jax_vjp(a, (2, CS, 55, 0), **kw)
    assert took == [True]
    seen = []
    real_ref = ops.cluster_attention_backward_reference

    def recording_ref(*args, saved=None, **kws):
        seen.append(saved is not None)
        return real_ref(*args, saved=saved, **kws)

    monkeypatch.setattr(ops, "cluster_attention_backward_reference",
                        recording_ref)
    got = _port_vjp(a, (2, CS, 55, 0))
    assert seen == [True]
    _assert_matches(got, want, _exact(a, (2, CS, 55, 0)))


def test_saved_backward_matches_recompute_and_the_switch(monkeypatch):
    """The port's saved and recompute backwards agree, and
    ``MLAFF_BWD_SAVED=0`` takes the recompute one, with dropout too."""
    a = _case(33, 2, 100, 4, 30, 2, 16)
    geo = (2, CS, 511, 1023)
    seen = []
    real_ref = ops.cluster_attention_backward_reference

    def recording_ref(*args, saved=None, **kws):
        seen.append(saved is not None)
        return real_ref(*args, saved=saved, **kws)

    monkeypatch.setattr(ops, "cluster_attention_backward_reference",
                        recording_ref)
    runs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("MLAFF_BWD_SAVED", flag)
        for drop in (0.0, 0.3):
            runs[flag, drop] = _port_vjp(a, geo, drop_rate=drop,
                                         drop_seed=7 if drop else None)
    assert seen == [True, True, False, False]
    for drop in (0.0, 0.3):
        assert _worst(runs["1", drop], runs["0", drop]) <= REL
    # at inference (no autograd) the forward writes no statistics
    monkeypatch.setenv("MLAFF_BWD_SAVED", "1")
    calls = []
    real_fwd = ops.cluster_attention_forward

    def recording_fwd(*args, want_stats=False, **kws):
        calls.append(want_stats)
        return real_fwd(*args, want_stats=want_stats, **kws)

    monkeypatch.setattr(ops, "cluster_attention_forward", recording_fwd)
    t = [torch.from_numpy(a[k]) for k in ARGS]
    with torch.no_grad():
        fused_cluster_attention(*t, *geo)
    q = t[0].clone().requires_grad_(True)
    fused_cluster_attention(q, *t[1:], *geo)
    assert calls == [False, True]


# -------------------------------------------------- on the card (cuda) ----

def _card_case(dev, dtype, name="random_ncc"):
    from test_torch_kernels import _stress_case

    a, h, cs, R, clamp = _stress_case(name, 17)
    t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
    for k in ("q", "kv", "g"):
        t[k] = t[k].to(dtype)
    return t, (h, cs, R, clamp)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random_ncc", "m760_repeats"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stats_saved_and_dropout_kernels_match_plain_on_card(
        cuda_device, dtype, name):
    """The forward's statistics and its dropout, and the saved and the
    dropout backward, against the plain versions (f64) on the same
    inputs: fp32 within 1e-4, bf16 within 2e-2 of max|ref|."""
    t, geo = _card_case(cuda_device, dtype, name)
    args = [t[k] for k in ARGS]
    f64 = [x.double() if x.is_floating_point() else x for x in args]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    drop = (0.1, 4242)

    def close(x, y):
        err = (x.double() - y.double()).abs().max().item()
        return err <= tol * y.double().abs().max().item()

    out, stats = cluster_attention_forward(*args, *geo, drop=drop,
                                           want_stats=True)
    ref, ref_stats = cluster_attention_reference(*f64, *geo, drop=drop,
                                                 want_stats=True)
    assert close(out, ref) and close(stats, ref_stats)
    got = cluster_attention_backward(*args, t["g"], *geo,
                                     saved=(out, stats), drop=drop)
    want = cluster_attention_backward_reference(
        *f64, t["g"].double(), *geo, saved=(out.double(), stats.double()),
        drop=drop)
    assert all(close(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [None, (0.1, 99)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_saved_and_dropout_backward_are_bitwise_reproducible_on_card(
        cuda_device, dtype, drop):
    """Two saved-stats backwards, with and without dropout, give the same
    bits for every output (b = 8, random ncc over several chunks)."""
    t, geo = _card_case(cuda_device, dtype)
    t = {k: (v.expand(8, *v.shape[1:]).contiguous() if v.dim() == 3 else v)
         for k, v in t.items()}
    args = [t[k] for k in ARGS]
    saved = cluster_attention_forward(*args, *geo, drop=drop,
                                      want_stats=True)
    first = cluster_attention_backward(*args, t["g"], *geo, saved=saved,
                                       drop=drop)
    second = cluster_attention_backward(*args, t["g"], *geo, saved=saved,
                                        drop=drop)
    torch.cuda.synchronize()
    for gname, x, y in zip(GRADS, first, second):
        assert torch.equal(x, y), gname
