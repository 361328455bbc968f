"""What the metric readers share: the traced window's device shares and
the kernels' shares of their rooflines, each the sum of the launches'
least times over the sum of their device times."""

from __future__ import annotations

from .roofline import cluster_sums, lloyd_grouped, lloyd_round


def idle_pct(rec) -> float | None:
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)


def device_seconds(rec, family: str) -> float:
    return sum(k[2] for k in rec.trace.family(family)) / 1e6


def lloyd_shapes(rec) -> tuple[list, list]:
    """``(K-B shapes, K-C shapes)`` of the traced builds, in launch order:
    the coarse fit's launches are K-B's; the PQ fit's are K-B's or K-C's,
    as the launch counts say. Raises where the counts fit neither."""
    coarse, pq = rec.work.get("coarse", []), rec.work.get("pq", [])
    kb, kc = rec.trace.launches("lloyd_round"), \
        rec.trace.launches("lloyd_grouped")
    if kb + kc == 0:
        return [], []                   # neither kernel is on the path
    if kb == len(coarse) + len(pq) and kc == 0:
        return coarse + pq, []
    if kb == len(coarse) and kc == len(pq):
        return coarse, pq
    raise RuntimeError(f"K-B {kb} and K-C {kc} launches fit neither split "
                       f"of {len(coarse)} coarse and {len(pq)} PQ rounds "
                       "the events give")


def share(least: float, seconds: float) -> float | None:
    return 100.0 * least / seconds if seconds > 0 and least > 0 else None


def lloyd_share(rec, family: str) -> float | None:
    if rec.trace is None or "coarse" not in rec.work:
        return None
    kb, kc = lloyd_shapes(rec)
    shapes, work = (kb, lloyd_round) if family == "lloyd_round" else \
        (kc, lloyd_grouped)
    if not shapes:
        return None
    least = sum(work.least_seconds(**s)[0] for s in shapes)
    return share(least, device_seconds(rec, family))


def sums_share(rec) -> float | None:
    if rec.trace is None or "coarse" not in rec.work:
        return None
    shapes = rec.work["coarse"] + rec.work["pq"]
    passes = rec.trace.launches("cluster_sums")
    if passes == 0:
        return None                     # the pass is off the path
    if passes != len(shapes):
        raise RuntimeError(f"{passes} cluster-sum passes against "
                           f"{len(shapes)} rounds the events give")
    least = sum(cluster_sums.least_seconds(**s)[0] for s in shapes)
    return share(least, device_seconds(rec, "cluster_sums"))
