"""``build_s``: the window's time over the builds completed in it (the
build in flight when the window's seconds ran out finished and counted)."""


def read(rec):
    w = rec.window
    done = sum(1 for c in w.calls if c.ok)
    return w.seconds / done if done else None
