"""``lloyd_grouped.roofline``: K-C's (``grouped_round_kernel``) share of
its roofline over the traced builds, as ``lloyd_round.roofline``; nothing
where the PQ fit ran K-B."""

from portbench.readers import lloyd_share


def read(rec):
    return lloyd_share(rec, "lloyd_grouped")
