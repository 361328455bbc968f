"""The launch counters of the PyTorch port's kernels
(``flechasdb_tpu_torch._kernels.LAUNCHES``): one per kernel route, all
zeroed by ``reset_launches``.
"""

from flechasdb_tpu_torch import _kernels


def test_launch_counters_cover_every_route():
    assert set(_kernels.LAUNCHES) == {"adc_scan", "adc_lookup",
                                      "lloyd_round", "lloyd_grouped"}
    _kernels.LAUNCHES["lloyd_grouped"] += 3
    _kernels.reset_launches()
    assert not any(_kernels.LAUNCHES.values())
