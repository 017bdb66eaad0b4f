"""Data, tensor, sequence and pipeline parallelism with ZeRO-1 across
processes (counterpart of the JAX package's ``parallel/``).

One process per card, as torchrun starts them: :mod:`.mesh` lays the world
out as the JAX package's ``(data, model, seq)`` mesh and keeps one process
group per axis; :mod:`.comm` holds the collectives the model and the
trainer call (no-ops on an axis of one rank); :mod:`.tp` shards the
attention and MLP layers over the ``model`` axis; :mod:`.zero` shards the
AdamW moments and the EMA over the ``data`` axis. A JAX host maps to a data
rank of the port: each data rank loads its own shard of the batch, and the
global batch is ``DATA.BATCH_SIZE x data``. :mod:`.pp` is GPipe over a
``(data, pipe)`` layout of its own, a library as JAX's is: no entry
point, config key or switch reaches it.

Sequence parallelism (the ``seq`` axis, JAX's ``shard_tokens``): the seq
ranks of a ``(data, model)`` pair load the same images. Each runs every
stage's transformer blocks on its token range (:func:`.mesh.token_range`)
and the rest of the model (patch embed, clustering, kNN, tile metadata,
``prob_net``, merges, MixRes splits and gates, heads, the loss) on whole
images, replicated. :func:`.comm.slice_tokens` cuts the range out before
the blocks; :func:`.comm.gather_tokens` puts the ranges together after
them and inside attention (k and v). Its backward is a reduce-scatter, the
slice's the slice's own (the gradient on the range, zero elsewhere).

The rule for the gradient: **every parameter's gradient is averaged over
the data x seq ranks of its model rank** (``Mesh.replica_group``), in the
one collective of the data-parallel mean. Why that is the one-process
gradient: on one data rank, let the whole gradient of a replicated
tensor be ``W`` (from replicated consumers, the same on every seq rank)
plus ``P`` (through the blocks). Each seq rank computes the loss whole, so
a gather's input gradient is ``W + seq P_s``, with ``P_s`` the share of
rank ``s``'s range; the reduce-scatter sums it over the ranks, so a
block sees ``seq`` times its rows' true gradient, and every gradient
inside the blocks, parameters and slice alike, is ``seq`` times rank
``s``'s share. Summed over the ``seq`` ranks those shares give the whole.
So on every rank a parameter's gradient is ``W + seq P_s``: ``W`` for a
replicated one (the patch embed, the merges, the heads), ``seq P_s`` for
one inside the blocks, a sum of both for a tensor used in both. Its mean
over the seq ranks is ``W + sum_s P_s``, the whole gradient, for every
parameter alike; no parameter needs to be told apart. ZeRO-1 cuts over
``data`` only, so the seq ranks of a data rank hold the same blocks, and
a checkpoint is written by rank 0 for its replicas.

The rule for the pipe axis (:mod:`.pp`), the same in spirit: every pipe
rank computes the loss whole on the replicated output of the chain. The
last stage's collected outputs are replicated by an all-reduce whose
backward is the identity (``comm.reduce_from_model``; a sum's backward
would hand the chain ``pipe`` times its gradient), and the chain's input
enters through the identity with an all-reduce backward
(``comm.copy_to_model``), so every pipe rank gets the input's whole
gradient, which only the first stage's injections receive. A block's
gradient lives on its own pipe rank, and the data ranks of that pipe
rank average it (``comm.all_reduce_mean_`` over the pipe mesh's data
group), as data parallelism does.
"""
