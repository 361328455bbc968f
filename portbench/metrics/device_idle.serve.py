"""``device_idle.serve``: the share of the traced serving window in which
no kernel, copy or set ran on the card (``torch.profiler``)."""

from portbench.readers import idle_pct as read  # noqa: F401
