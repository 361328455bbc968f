"""``qps``: the queries answered in the window over the window's time
(from its opening to the last call's results on the host)."""


def read(rec):
    w = rec.window
    return w.items / w.seconds if w.calls and w.seconds > 0 else None
