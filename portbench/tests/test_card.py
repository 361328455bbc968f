"""On the card: a traced window records every K-A launch the program
counts, and the readers read a share of K-A's roofline from it."""

import pytest
import torch

from portbench import tracing
from portbench.roofline import adc_scan


@pytest.mark.cuda
def test_a_traced_scan_is_counted_and_read(card, tmp_path):
    from flechasdb_tpu_torch import _kernels
    from flechasdb_tpu_torch.ops.scan import adc_lookup_indexed

    g, l, d, c = 640, 1280, 8, 256
    codes = torch.randint(0, 1 << 30, (64, 2, l), dtype=torch.int32,
                          device=card)
    ftab = torch.rand((g, d * c), device=card)
    bidx = torch.randint(0, 64, (g,), dtype=torch.int32, device=card)
    lens = torch.full((g,), l, dtype=torch.int32, device=card)

    def window():
        for _ in range(20):
            adc_lookup_indexed(codes, ftab, bidx, lens, d=d)
        torch.cuda.synchronize()

    trace, _ = tracing.traced(window, _kernels.LAUNCHES, ["adc_scan"],
                              tmp_path / "t.json")
    assert trace.launches("adc_scan") == 20
    least = 20 * adc_scan.least_seconds(real_slots=g * l, g=g, d=d,
                                        c=c)[0]
    spent = sum(k[2] for k in trace.family("adc_scan")) / 1e6
    assert 0 < least / spent <= 1.05
