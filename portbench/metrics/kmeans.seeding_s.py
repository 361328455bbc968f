"""``kmeans.seeding_s``: the seconds a build spends seeding its fits
(coarse and PQ k-means++), between each fit's
``StartingCentroidInitialization`` and ``FinishedCentroidInitialization``
events, the card synchronized at both, in a build of the traced run made
outside the profiler."""


def read(rec):
    s = rec.work.get("seeding_s")
    return sum(s) / len(s) if s else None
