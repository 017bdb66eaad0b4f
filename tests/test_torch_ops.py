"""The port's geometry ops against the JAX package's, on the same numpy
inputs: cluster gathers, kNN (with an equal-distance tie), the nearest-other
distance, space-filling clustering (b = 2, so the batch-wide max of the
sort key matters), the on-grid host constants and the merge contraction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ml_autofocusformermod_tpu.ops.cluster_gather as jg
import ml_autofocusformermod_tpu.ops.clusten as jc
import ml_autofocusformermod_tpu.ops.sfc as js
from ml_autofocusformermod_tpu.ops.knn import knn as jknn
from ml_autofocusformermod_tpu.ops.knn import nearest_other_distance as jnod
from ml_autofocusformermod_torch.ops import cluster_gather as tg
from ml_autofocusformermod_torch.ops import clusten as tc
from ml_autofocusformermod_torch.ops import knn as tk
from ml_autofocusformermod_torch.ops import sfc as ts

torch.set_num_threads(1)
ATOL, RTOL = 1e-5, 1e-4  # fp32 envelope of tests/test_pallas_kernel.py:453


def _distinct_positions(rng, b, n, h, w):
    """(b, n, 2) float32 distinct integer cells (x, y) of an h x w canvas."""
    out = np.empty((b, n, 2), np.float32)
    for i in range(b):
        cells = rng.choice(h * w, size=n, replace=False)
        out[i, :, 0] = cells % w
        out[i, :, 1] = cells // w
    return out


@pytest.mark.parametrize("n", [64, 52])  # 52: padded last cluster
def test_gather_clusters_matches_jax(n):
    rng = np.random.default_rng(0)
    b, h, c, cs, n_out, nnc = 2, 3, 5, 8, 11, 3
    k = -(-n // cs)
    vals = rng.standard_normal((b, h, n, c)).astype(np.float32)
    ncc = rng.integers(0, k, size=(b, n_out, nnc)).astype(np.int32)
    ref = jg.gather_clusters_onehot(jnp.asarray(vals), jnp.asarray(ncc), cs)
    out = tg.gather_clusters(torch.from_numpy(vals), torch.from_numpy(ncc), cs)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_gather_rows_matches_jax():
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((2, 9, 4)).astype(np.float32)
    idx = rng.integers(0, 9, size=(2, 5)).astype(np.int32)
    ref = jg.gather_rows(jnp.asarray(vals), jnp.asarray(idx))
    out = tg.gather_rows(torch.from_numpy(vals), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_knn_matches_jax_with_ties():
    rng = np.random.default_rng(2)
    q = _distinct_positions(rng, 2, 40, 12, 12)
    d = rng.integers(0, 12, size=(2, 9, 2)).astype(np.float32)
    d[:, 3:] += 0.5  # means of clusters sit on half cells
    # equal-distance tie: database points 0 and 1 straddle query 0
    q[:, 0] = (5.0, 5.0)
    d[:, 0] = (3.0, 5.0)
    d[:, 1] = (7.0, 5.0)
    d[:, 2] = (5.0, 3.0)
    k = 4
    ri, rd = jknn(jnp.asarray(q), jnp.asarray(d), k, return_dist=True)
    oi, od = tk.knn(torch.from_numpy(q), torch.from_numpy(d), k,
                    return_dist=True)
    assert oi.dtype == torch.int32
    np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(od.numpy(), np.asarray(rd), atol=ATOL, rtol=RTOL)
    # the tie resolves to the lower index, as in the JAX package
    assert oi[0, 0, :3].tolist() == [0, 1, 2]


def test_nearest_other_distance_matches_jax():
    rng = np.random.default_rng(3)
    pos = _distinct_positions(rng, 2, 30, 10, 10)
    ref = jnod(jnp.asarray(pos))
    out = tk.nearest_other_distance(torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("n,m,h,w", [(196, 8, 28, 28), (784, 8, 56, 56)])
def test_space_filling_cluster_matches_jax(n, m, h, w):
    rng = np.random.default_rng(4)
    pos = _distinct_positions(rng, 2, n, h, w)
    ref = js.space_filling_cluster(jnp.asarray(pos), m, h, w)
    out = ts.space_filling_cluster(torch.from_numpy(pos), m, h, w)
    names = ["pos_sorted", "cluster_mean_pos", "member_idx", "cluster_mask",
             "pos_ranking"]
    for name, r, o in zip(names, ref, out):
        if r is None:
            assert o is None, name
            continue
        np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=name)
    if n % m:
        assert out[3] is not None


def test_space_filling_key_uses_batch_wide_max():
    """The sort key's scale is the max over the whole batch (sfc.py:348):
    clustering an image alone and inside a batch agree exactly with the
    JAX package either way."""
    rng = np.random.default_rng(5)
    pos = _distinct_positions(rng, 2, 196, 28, 28)
    pos[1] *= 0.5  # second image: a different dist-ratio range
    pos = np.floor(pos)
    for batch in (pos, pos[:1]):
        ref = js.space_filling_cluster(jnp.asarray(batch), 8, 28, 28)[4]
        out = ts.space_filling_cluster(torch.from_numpy(batch), 8, 28, 28)[4]
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("h,w,m,nnc", [(16, 16, 8, 3), (14, 14, 8, 6),
                                       (7, 7, 8, 6), (56, 56, 8, 6)])
def test_grid_constants_match_jax(h, w, m, nnc):
    ref = js.grid_cluster(h, w, m)
    out = ts.grid_cluster(h, w, m)
    for r, o in zip(ref, out):
        if r is None:
            assert o is None
            continue
        np.testing.assert_array_equal(o, r)
    np.testing.assert_array_equal(ts.grid_nearest_clusters(h, w, m, nnc),
                                  js.grid_nearest_clusters(h, w, m, nnc))
    g_pos, g_reorder, g_ncc = ts.grid_tensors(h, w, m, nnc, torch.device("cpu"))
    assert g_ncc.dtype == torch.int32
    np.testing.assert_array_equal(g_reorder.numpy(), ref[4])


def test_wf_contract_matches_jax():
    rng = np.random.default_rng(6)
    wts = rng.standard_normal((2, 7, 24, 4)).astype(np.float32)
    fg = rng.standard_normal((2, 7, 24, 10)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jc.wf_contract(jnp.asarray(wts), jnp.asarray(fg))
    out = tc.wf_contract(torch.from_numpy(wts), torch.from_numpy(fg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
