"""Percent of the cluster-merge kernels' least time over the device time of
every kernel launched inside ``mlaff::cluster_merge_fwd``, ``_bwd`` and
``mlaff::merge_inverse_index`` (the index's time counts against the
merge's work)."""

from h100bench import trace

OPS = ("mlaff::cluster_merge_fwd", "mlaff::cluster_merge_bwd",
       "mlaff::merge_inverse_index")


def read(run):
    return trace.roofline(run.summary, OPS)
