"""``serve.graph_pct``: the share of the traced window's batches that the
program answered by replaying CUDA graphs: its ``graph.replays`` counter
over ``graph.replays`` and ``graph.eager`` (the bucketed batches on the
card that ran op by op), in %. A share, so the scale ``counted`` puts on
counters that a discarded window also counted cancels. Nothing where the
program has no such counter or replayed no batch."""

from portbench import counted


def read(rec):
    if counted.in_window(rec, "graph.replays") is None:
        return None
    from flechasdb_tpu_torch.utils.profiling import counters

    got = counters()
    replays = got["graph.replays"]
    return 100.0 * replays / (replays + got.get("graph.eager", 0))
