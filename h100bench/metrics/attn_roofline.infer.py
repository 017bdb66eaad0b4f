"""Percent of the cluster-attention kernels' least time (their bytes at
3.35 TB/s or flops at the dtype's peak, whichever is longer, from
``work.py`` at the recorded shapes) over the device time of every kernel
launched inside ``mlaff::cluster_attention_fwd`` and ``_bwd``."""

from h100bench import trace

OPS = ("mlaff::cluster_attention_fwd", "mlaff::cluster_attention_bwd")


def read(run):
    return trace.roofline(run.summary, OPS)
