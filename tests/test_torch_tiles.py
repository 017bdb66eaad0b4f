"""The attention kernels' tile metadata (``tile_metadata``) and its path
through the model.

The CUDA kernels stage, per tile of ``TILE`` query rows, the union of the
tile's neighbour clusters; ``tile_metadata`` lists that union and, per
(query, cluster), the cluster's index in it. These tests hold the
metadata to its definition at small shapes: every (query, slot) token is
found at its recorded union index; a padded last cluster, a
batch-broadcast ``ncc``, ``cs = 1`` and a tile size that does not divide
``n`` included. The kernels themselves run only on the card
(``tests/test_torch_kernels.py``, ``tests/test_torch_grad.py``).
"""

import numpy as np
import pytest
import torch

from ml_autofocusformermod_torch.models.aff import AutoFocusFormer
from ml_autofocusformermod_torch.ops import sfc
from ml_autofocusformermod_torch.ops.cluster_attention import (
    TILE, _meta_args, cluster_attention_backward, cluster_attention_reference,
    constant_tile_metadata, fused_cluster_attention, tile_metadata,
)
from ml_autofocusformermod_torch.ops.cluster_gather import cluster_token_index

torch.set_num_threads(1)


def _distinct_ncc(rng, b, n, nnc, cs):
    """Each row lists nnc distinct clusters of the ceil(n / cs), as kNN
    does."""
    k = -(-n // cs)
    ncc = np.argsort(rng.uniform(size=(b, n, k)), axis=-1)[:, :, :nnc]
    return torch.from_numpy(ncc.astype(np.int32))


def _assert_meta_covers(ncc, cs, meta):
    b, n, nnc = ncc.shape
    B = meta.nidx.shape[0]
    nt = -(-n // TILE)
    assert tuple(meta.ucl.shape) == (B, nt, TILE * nnc)
    assert tuple(meta.ucount.shape) == (B, nt)
    assert tuple(meta.nidx.shape) == (B, nt * TILE, nnc)
    assert all(t.dtype == torch.int32 for t in meta)
    src = ncc[:B]
    tile = torch.arange(n) // TILE
    nidx = meta.nidx[:, :n].long()
    count = meta.ucount.long()[:, tile]  # (B, n)
    assert bool((nidx >= 0).all()) and bool((nidx < count[..., None]).all())
    # each row lists its union indices in ascending order ...
    assert bool((nidx[..., 1:] >= nidx[..., :-1]).all())
    # ... and every slot's token sits at one of them, as often as it occurs
    ucl_rows = meta.ucl.long()[:, tile]  # (B, n, TILE * nnc)
    found = torch.gather(ucl_rows, 2, nidx)  # the union cluster per slot
    slot_tok = cluster_token_index(src.sort(-1)[0], cs)
    union_tok = cluster_token_index(found.to(torch.int32), cs)
    assert torch.equal(slot_tok, union_tok)
    # each union is the sorted set of its tile's clusters, nothing more
    for bi in range(B):
        for t in range(nt):
            rows = src[bi, t * TILE:(t + 1) * TILE]
            want = torch.unique(rows.long())
            u = meta.ucl[bi, t, :meta.ucount[bi, t]].long()
            assert torch.equal(u, want), (bi, t)


@pytest.mark.parametrize("b,n,nnc,cs", [
    (2, 196, 3, 8),   # padded last cluster (196 = 24 * 8 + 4), 196 % 64 != 0
    (1, 150, 6, 8),   # the last tile holds 22 rows
    (2, 100, 48, 1),  # cs = 1 with nnc = 48 (the MixRes k == n case)
    (1, 64, 2, 4),    # one full tile
])
def test_tile_metadata_finds_every_slot(b, n, nnc, cs):
    rng = np.random.default_rng(n + nnc)
    ncc = _distinct_ncc(rng, b, n, nnc, cs)
    before = tile_metadata.calls
    meta = tile_metadata(ncc)
    assert tile_metadata.calls == before + 1
    assert meta.nidx.shape[0] == b
    _assert_meta_covers(ncc, cs, meta)


def test_tile_metadata_of_a_broadcast_ncc_is_one_image():
    """The on-grid stage's ncc is one image's, expanded over the batch
    (stride 0): the metadata is computed once, for that image, and the
    kernels read it with batch stride 0."""
    rng = np.random.default_rng(3)
    one = _distinct_ncc(rng, 1, 200, 6, 8)
    ncc = one.expand(4, 200, 6)
    meta = tile_metadata(ncc)
    assert meta.nidx.shape[0] == 1
    _assert_meta_covers(ncc, 8, meta)
    assert _meta_args(meta, ncc)[1] == 0  # broadcast to the kernel


def test_tile_metadata_of_the_grid_is_cached():
    """Stage 1's metadata is that of the cached grid ncc, made once."""
    g_ncc = sfc.grid_tensors(16, 16, 8, 3, torch.device("cpu"))[2]
    first = constant_tile_metadata(g_ncc)
    before = tile_metadata.calls
    again = constant_tile_metadata(g_ncc)
    assert again is first and tile_metadata.calls == before
    assert first.nidx.shape[0] == 1
    _assert_meta_covers(g_ncc[None], 8, first)


def test_tile_metadata_keeps_a_repeated_cluster():
    """A row that lists a cluster twice finds it twice, at neighbouring
    entries of its sorted union indices (the kernels count it twice, as
    the plain version does)."""
    rng = np.random.default_rng(6)
    ncc = _distinct_ncc(rng, 2, 100, 4, 8)
    ncc[:, ::3, 1] = ncc[:, ::3, 0]  # every third row repeats a cluster
    meta = tile_metadata(ncc)
    _assert_meta_covers(ncc, 8, meta)
    rows = meta.nidx[:, :100:3]
    assert bool((rows[..., 1:] == rows[..., :-1]).any(-1).all())


def test_meta_args_refuse_metadata_of_another_ncc():
    rng = np.random.default_rng(4)
    ncc = _distinct_ncc(rng, 2, 130, 3, 8)
    meta, batched = _meta_args(None, ncc)
    assert batched == 1
    _assert_meta_covers(ncc, 8, meta)
    with pytest.raises(ValueError, match="tile metadata"):
        _meta_args(tile_metadata(ncc[:, :100].contiguous()), ncc)


def test_attention_takes_the_metadata_on_every_path():
    """The wrappers accept the metadata on the CPU too (where the plain
    versions do not need it), forward and backward, with the same result
    as without it."""
    rng = np.random.default_rng(5)
    b, n, h, c_, cs = 2, 70, 2, 8, 8
    ncc = _distinct_ncc(rng, b, n, 3, cs)
    f = dict(
        q=rng.standard_normal((b, n, h * c_)), kv=rng.standard_normal(
            (b, n, 2 * h * c_)), pos=rng.integers(0, 12, (b, n, 2)),
        pe_kernel=rng.standard_normal((5, h)) * 0.1,
        pe_bias=rng.standard_normal(h) * 0.1,
        blank_k=rng.standard_normal((c_, h)), blank_v=rng.standard_normal(
            (h, c_)), g=rng.standard_normal((b, n, h * c_)))
    t = {k: torch.from_numpy(v.astype(np.float32)) for k, v in f.items()}
    args = [t["q"], t["kv"], ncc, t["pos"], t["pe_kernel"], t["pe_bias"],
            t["blank_k"], t["blank_v"]]
    meta = tile_metadata(ncc)
    out = fused_cluster_attention(*args, h, cs, 5, meta=meta)
    torch.testing.assert_close(
        out, cluster_attention_reference(*args, h, cs, 5), rtol=0, atol=0)
    with_meta = cluster_attention_backward(*args, t["g"], h, cs, 5,
                                           meta=meta)
    without = cluster_attention_backward(*args, t["g"], h, cs, 5)
    for x, y in zip(with_meta, without):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_model_makes_the_metadata_once_per_stage():
    """AFF at 112^2 (stages of 784, 196, 49 and 12 tokens): stage 1 takes
    the cached grid metadata, stages 2 and 3 make theirs once each where
    ncc is made, and the global stage 4 needs none."""
    torch.manual_seed(0)
    model = AutoFocusFormer(
        num_classes=10, embed_dim=(16, 32, 48, 64), cluster_size=8,
        nbhd_size=(48, 48, 48, 49), depths=(2, 2, 2, 1),
        num_heads=(2, 2, 4, 4), img_size=112).eval()
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 112, 112)
    with torch.no_grad():
        model(x)  # the grid metadata is cached from here on
        before = tile_metadata.calls
        model(x)
    assert tile_metadata.calls == before + 2


# ------------------------------ the backward's deterministic dk/dv sums ----

def _owner_order_dkv(a, rel_width):
    """dkv summed as the CUDA backward sums it, with no atomics: each tile
    adds its rows' slot terms into one row per union position (the tile
    partials, ``union_rows`` rows per tile), and each cluster's rows are
    the sum of the partials of the tiles whose sorted union names it
    (found by a binary search), in ascending tile order."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        _softmax_parts, union_rows,
    )
    from test_torch_grad import CS, H

    t = {k: torch.from_numpy(v) for k, v in a.items()}
    b, n, c = t["q"].shape
    c_ = c // H
    qh, _, vg, _, p, pb, _, _ = _softmax_parts(
        t["q"], t["kv"], t["ncc"], t["pos"], t["pe_kernel"], t["pe_bias"],
        t["blank_k"], H, CS, rel_width, 0)
    goh = t["g"].reshape(b, n, H, c_).permute(0, 2, 1, 3)
    dp = torch.einsum("bhic,bhimc->bhim", goh, vg)
    dpb = torch.einsum("bhic,hc->bhi", goh, t["blank_v"])[..., None]
    dl = p * (dp - ((dp * p).sum(-1, keepdim=True) + dpb * pb))
    terms = torch.stack([qh[:, :, :, None] * dl[..., None],
                         p[..., None] * goh[:, :, :, None]], dim=-2)
    terms = terms.permute(0, 2, 3, 1, 4, 5).reshape(b, n, -1, 2 * c)
    meta = tile_metadata(t["ncc"])
    nt, ucap, nnc = -(-n // TILE), union_rows(meta, CS), t["ncc"].shape[2]
    part = torch.zeros(b, nt, ucap, 2 * c)
    for bi in range(b):
        for tile in range(nt):
            union = meta.ucl[bi, tile, :meta.ucount[bi, tile]].long()
            for i in range(tile * TILE, min(n, (tile + 1) * TILE)):
                for j in range(nnc):
                    cl = int(t["ncc"][bi, i, j])
                    u = int(torch.searchsorted(union, cl))
                    for r in range(min(CS, n - cl * CS)):
                        part[bi, tile, u * CS + r] += terms[bi, i, j * CS + r]
    dkv = torch.zeros(b, n, 2 * c)
    for bi in range(b):
        for cl in range(-(-n // CS)):
            rows = min(CS, n - cl * CS)
            for tile in range(nt):  # ascending, as the owner block sums
                union = meta.ucl[bi, tile, :meta.ucount[bi, tile]].long()
                u = int(torch.searchsorted(union, cl))
                if u < len(union) and int(union[u]) == cl:
                    dkv[bi, cl * CS:cl * CS + rows] += \
                        part[bi, tile, u * CS:u * CS + rows]
    return dkv.numpy(), meta, ucap


@pytest.mark.parametrize("n,nnc,hw", [(196, 6, 28), (100, 4, 14)])
def test_owner_order_dkv_matches_jax(n, nnc, hw):
    """The CUDA backward's two-pass dk/dv sum, emulated in plain torch,
    against ``jax.vjp`` of the JAX attention (padded last cluster
    included); and the partials' rows per tile are the largest union's."""
    from test_torch_grad import _assert_grads, _attention_case, \
        _jax_attention_vjp

    a = _attention_case(np.random.default_rng(n), 2, n, nnc, hw)
    dkv, meta, ucap = _owner_order_dkv(a, hw - 1)
    assert ucap == int(meta.ucount.max()) * 8
    ref = _jax_attention_vjp(a, hw - 1)
    _assert_grads([dkv], [ref[1]], ["kv"])
