"""The merge backward's inverse index (``merge_inverse_index``) and the
owner-order backward the CUDA kernel computes on it.

``csrc/cluster_merge_bwd.cu`` gives each cluster one owner (a warp, or a
block) and the list of the (centre, slot) pairs that name it. These tests hold the index to its
definition against a numpy brute force (aligned clusters, a padded last
cluster, repeats in one row, clusters no centre names, b = 1), and hold a
plain-torch emulation of the kernel's arithmetic on that index - per
cluster dW = G F^T and dF = W G, summed in list order - against
``jax.vjp`` of the JAX package's ``fused_cluster_merge``. On the card the
index is a counting-sort kernel, held here (``cuda``-marked) to the same
lists as its plain version; the backward kernel itself runs only on the
card (``tests/test_torch_grad.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_autofocusformermod_tpu.ops.merge_pallas import (
    fused_cluster_merge as jax_merge,
)
from ml_autofocusformermod_torch.ops.cluster_merge import (
    MergeIndex, cluster_merge_reference, fused_cluster_merge,
    merge_inverse_index, merge_inverse_index_reference,
)

torch.set_num_threads(1)


def _brute_lists(ncc, k):
    """Per image and cluster, the flat pairs t * nnc + j that name it, in
    ascending order."""
    b, n_, nnc = ncc.shape
    return [[[t * nnc + j for t in range(n_) for j in range(nnc)
              if ncc[bi, t, j] == kappa] for kappa in range(k)]
            for bi in range(b)]


def _ncc(kind, b, n, n_, nnc, cs, seed):
    rng = np.random.default_rng(seed)
    k = -(-n // cs)
    if kind == "distinct":
        ncc = np.argsort(rng.uniform(size=(b, n_, k)), -1)[..., :nnc]
    elif kind == "repeats":
        ncc = rng.integers(0, k, size=(b, n_, nnc))
        ncc[:, ::2, 1] = ncc[:, ::2, 0]  # every other row: a cluster twice
    else:  # "crowded": every centre names the first nnc + 1 clusters only
        ncc = rng.integers(0, min(k, nnc + 1), size=(b, n_, nnc))
    return ncc.astype(np.int32)


INDEX_CASES = [  # kind, b, n, n', nnc, cs
    ("distinct", 2, 64, 16, 3, 8),   # aligned: cs divides n
    ("distinct", 2, 52, 12, 3, 8),   # padded last cluster (52 = 6 * 8 + 4)
    ("repeats", 2, 48, 12, 4, 4),    # rows that list a cluster twice
    ("crowded", 2, 80, 20, 3, 8),    # most clusters named by no centre
    ("distinct", 1, 49, 13, 6, 8),   # b = 1, AFF-Mini merge 3's padding
]


@pytest.mark.parametrize("kind,b,n,n_,nnc,cs", INDEX_CASES)
def test_merge_inverse_index_lists_every_pair(kind, b, n, n_, nnc, cs):
    ncc = _ncc(kind, b, n, n_, nnc, cs, seed=n + nnc)
    k = -(-n // cs)
    before = merge_inverse_index.calls
    index = merge_inverse_index(torch.from_numpy(ncc), n, cs)
    assert merge_inverse_index.calls == before + 1
    assert isinstance(index, MergeIndex)
    assert index.entry.dtype == index.offset.dtype == torch.int32
    assert tuple(index.entry.shape) == (b, n_ * nnc)
    assert tuple(index.offset.shape) == (b, k + 1)
    entry, offset = index.entry.numpy(), index.offset.numpy()
    lists = _brute_lists(ncc, k)
    for bi in range(b):
        assert offset[bi, 0] == 0 and offset[bi, k] == n_ * nnc
        for kappa in range(k):
            got = entry[bi, offset[bi, kappa]:offset[bi, kappa + 1]]
            assert got.tolist() == lists[bi][kappa], (bi, kappa)
    if kind == "crowded":
        assert (np.diff(offset, axis=1) == 0).sum() >= b * (k - nnc - 1)


@pytest.mark.parametrize("kind,b,n,n_,nnc,cs", INDEX_CASES[:2])
def test_merge_inverse_index_on_cpu_is_the_plain_version(kind, b, n, n_, nnc,
                                                         cs):
    """On a CPU tensor the index is its plain version and launches
    nothing."""
    ncc = torch.from_numpy(_ncc(kind, b, n, n_, nnc, cs, seed=n))
    before = merge_inverse_index.launches
    got = merge_inverse_index(ncc, n, cs)
    want = merge_inverse_index_reference(ncc, n, cs)
    assert merge_inverse_index.launches == before
    assert all(torch.equal(x, y) for x, y in zip(got, want))


# on the card: INDEX_CASES, AFF-Mini's first merge (147 ids per warp), and
# more clusters than the kernel's 512-cluster range (k = 525 and 17500)
CARD_INDEX_CASES = INDEX_CASES + [
    ("distinct", 2, 3136, 784, 6, 8),
    ("distinct", 2, 4200, 1050, 6, 8),
    ("repeats", 2, 140000, 50, 6, 8),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,n,n_,nnc,cs", CARD_INDEX_CASES)
def test_merge_inverse_index_kernel_matches_plain_on_card(
        cuda_device, kind, b, n, n_, nnc, cs):
    ncc = torch.from_numpy(_ncc(kind, b, n, n_, nnc, cs, seed=n)).to(
        cuda_device)
    before = merge_inverse_index.launches
    got = merge_inverse_index(ncc, n, cs)
    want = merge_inverse_index_reference(ncc, n, cs)
    torch.cuda.synchronize()
    assert merge_inverse_index.launches == before + 1
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_merge_forward_without_gradients_skips_autograd():
    """Without a gradient to take (inference, or inputs that need none) the
    forward runs outside autograd; the result is the same."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((2, 12, 24, 4)).astype(
        np.float32))
    f = torch.from_numpy(rng.standard_normal((2, 52, 8)).astype(np.float32))
    ncc = torch.from_numpy(_ncc("distinct", 2, 52, 12, 3, 8, seed=1))
    want = cluster_merge_reference(w, f, ncc, 8)
    out = fused_cluster_merge(w, f, ncc, 8)
    assert out.grad_fn is None and torch.equal(out, want)
    w.requires_grad_(True)
    with torch.no_grad():
        assert fused_cluster_merge(w, f, ncc, 8).grad_fn is None
    out = fused_cluster_merge(w, f, ncc, 8)
    # the op mlaff::cluster_merge_fwd's autograd formula
    assert type(out.grad_fn).__name__ == (
        "GeneratedBackwardFor_mlaff_cluster_merge_fwd_defaultBackward")
    assert torch.equal(out.detach(), want)


def _owner_order_backward(w, feat, ncc, cs, g, index):
    """The kernel's arithmetic in plain torch (f64): per image and cluster,
    G (L*4 x c) the list's gradient rows, F (cs x c) the cluster's rows
    (zero past n) and W (cs x L*4); dW^T = G F^T lands in dw once, and
    dF = W G, summed in list order, is the cluster's dfeat rows."""
    b, n_, m, ic = w.shape
    n, c = feat.shape[1], feat.shape[2]
    nnc = ncc.shape[2]
    k = -(-n // cs)
    dw = torch.full_like(w, float("nan"))  # every entry must be written
    dfeat = torch.full_like(feat, float("nan"))
    fpad = torch.cat([feat, feat.new_zeros(b, k * cs - n, c)], 1)
    for bi in range(b):
        for kappa in range(k):
            lo, hi = index.offset[bi, kappa], index.offset[bi, kappa + 1]
            pairs = index.entry[bi, lo:hi].long()
            t, j = pairs // nnc, pairs % nnc
            F = fpad[bi, kappa * cs:(kappa + 1) * cs]  # cs x c
            G = g[bi, t].reshape(-1, c)  # L*4 x c, rows (l, i)
            slots = j[:, None] * cs + torch.arange(cs)  # L x cs
            W = w[bi, t[:, None], slots]  # L x cs x ic
            Wk = W.permute(1, 0, 2).reshape(cs, -1)  # cs x L*4
            dW = (G @ F.T).reshape(-1, ic, cs).permute(0, 2, 1)  # L cs ic
            dw[bi, t[:, None], slots] = dW
            dF = torch.zeros(cs, c, dtype=w.dtype)
            for col in range(Wk.shape[1]):  # in list order
                dF += Wk[:, col:col + 1] * G[col]
            rows = min(cs, n - kappa * cs)
            dfeat[bi, kappa * cs:kappa * cs + rows] = dF[:rows]
    return dw, dfeat


BWD_CASES = [  # tests/test_merge_pallas.py:41-45 (MERGE_CASES), and repeats
    ("distinct", 2, 64, 16, 32, 8, 3),
    ("distinct", 1, 48, 12, 16, 4, 2),
    ("distinct", 2, 52, 12, 8, 8, 3),
    ("repeats", 2, 44, 10, 8, 4, 5),
]

_jax_vjp = jax.jit(
    lambda w, f, ncc, g, cs: jax.vjp(
        lambda w, f: jax_merge(w, f, ncc, cs), w, f)[1](g),
    static_argnums=4)


@pytest.mark.parametrize("kind,b,n,n_,c,cs,nnc", BWD_CASES)
def test_owner_order_backward_matches_jax(kind, b, n, n_, c, cs, nnc):
    rng = np.random.default_rng(n * c)
    w = rng.standard_normal((b, n_, nnc * cs, 4)).astype(np.float32)
    feat = rng.standard_normal((b, n, c)).astype(np.float32)
    g = rng.standard_normal((b, n_, 4, c)).astype(np.float32)
    ncc = _ncc(kind, b, n, n_, nnc, cs, seed=c)
    with jax.default_matmul_precision("highest"):
        ref = [np.asarray(x) for x in _jax_vjp(
            jnp.asarray(w), jnp.asarray(feat), jnp.asarray(ncc),
            jnp.asarray(g), cs)]
    index = merge_inverse_index(torch.from_numpy(ncc), n, cs)
    got = _owner_order_backward(
        torch.from_numpy(w).double(), torch.from_numpy(feat).double(),
        torch.from_numpy(ncc), cs, torch.from_numpy(g).double(), index)
    for name, x, y in zip(("dw", "dfeat"), got, ref):
        x = x.numpy()
        assert np.isfinite(x).all(), name
        scale = max(np.abs(y).max(), 1e-6)
        np.testing.assert_allclose(x / scale, y / scale, atol=2e-6, rtol=0,
                                   err_msg=name)
