"""Data and tensor parallelism with ZeRO-1 across processes (counterpart of
the JAX package's ``parallel/``).

One process per card, as torchrun starts them: :mod:`.mesh` lays the world
out as the JAX package's ``(data, model, seq)`` mesh and keeps one process
group per axis; :mod:`.comm` holds the collectives the model and the
trainer call (no-ops on an axis of one rank); :mod:`.tp` shards the
attention and MLP layers over the ``model`` axis; :mod:`.zero` shards the
AdamW moments and the EMA over the ``data`` axis. A JAX host maps to a data
rank of the port: each data rank loads its own shard of the batch, and the
global batch is ``DATA.BATCH_SIZE x data``. Sequence and pipeline
parallelism (``shard_tokens``, ``pp.py``) are not ported.
"""
