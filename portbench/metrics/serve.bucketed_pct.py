"""``serve.bucketed_pct``: the share of the traced window's batches on
the card that the program answered from the bucketed layout: its
``graph.replays`` and ``graph.eager`` counters (the bucketed batches,
replayed or op by op) over those and ``serve.masked`` (the batches the
masked layout answered), in %. A share, so the scale ``counted`` puts on
counters that a discarded window also counted cancels. Nothing where the
run is untraced or none of the three was counted (a program without
them)."""

NAMES = ("graph.replays", "graph.eager", "serve.masked")


def read(rec):
    if rec.trace is None or not rec.window.calls:
        return None
    try:
        from flechasdb_tpu_torch.utils.profiling import counters
    except ImportError:
        return None                     # a program without counters
    replays, eager, masked = (counters().get(n, 0) for n in NAMES)
    total = replays + eager + masked
    if total <= 0:
        return None
    return 100.0 * (replays + eager) / total
