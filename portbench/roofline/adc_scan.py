"""K-A (``csrc/adc_scan.cu``): the ADC scan of the probed buckets.

One launch scores ``g`` (query, probed partition) cells. Its least work
reads, once each, the codes of the rows the probed partitions really hold
(``real_slots`` of them, ``ceil(D/4)`` int32 words a slot when the codes
are packed a byte each, else ``D``), each cell's ``[D, C]`` f32 table,
and writes one f32 key a real slot: ``D`` adds a slot. Pad slots are no
work (a scan could skip them), so they are not counted.
"""

from __future__ import annotations

from .. import bounds, peaks


def code_words(d: int, c: int) -> int:
    """int32 words a slot: four byte codes a word when every code fits a
    byte and D > 1, else one word a division."""
    return -(-d // 4) if (d > 1 and c <= 256) else d


def least_seconds(*, real_slots: int, g: int, d: int, c: int,
                  ) -> tuple[float, str]:
    nbytes = 4 * (real_slots * code_words(d, c) + g * d * c + real_slots)
    return bounds.bound(nbytes, float(real_slots) * d, peaks.FP32_FLOPS)
