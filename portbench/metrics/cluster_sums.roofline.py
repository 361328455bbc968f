"""``cluster_sums.roofline``: the cluster-sum pass's share of its roofline
over the traced builds: each pass's least time (``roofline/
cluster_sums.py``: x and the assignment read once, sums and counts written
once) summed, over the device time of all the pass's kernels."""

from portbench.readers import sums_share as read  # noqa: F401
