"""``lloyd_round.roofline``: K-B's (``assign_kernel``) share of its
roofline over the traced builds: each launch's least time
(``roofline/lloyd_round.py``, shapes from the configuration and the fits'
events) summed, over the launches' summed device time (profiler)."""

from portbench.readers import lloyd_share


def read(rec):
    return lloyd_share(rec, "lloyd_round")
