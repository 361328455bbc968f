"""Each kernel's work against shapes counted by hand."""

import pytest

from portbench import peaks
from portbench.roofline import adc_scan, cluster_sums, lloyd_grouped, \
    lloyd_round


def test_code_words():
    assert adc_scan.code_words(8, 256) == 2          # packed, a byte a code
    assert adc_scan.code_words(60, 256) == 15
    assert adc_scan.code_words(12, 256) == 3
    assert adc_scan.code_words(8, 1024) == 8         # a word a code
    assert adc_scan.code_words(1, 256) == 1


def test_adc_scan_counts_live_slots_tables_and_keys():
    t, by = adc_scan.least_seconds(real_slots=1000, g=10, d=8, c=256)
    # 1000 slots × (2 code words + 1 key) + 10 tables of 8 × 256 floats
    assert t == pytest.approx(4 * (1000 * 2 + 10 * 8 * 256 + 1000)
                              / peaks.HBM_BYTES_PER_S)
    assert by == "bytes"


def test_kb_deep10m_coarse_round_is_bound_by_tf32_operations():
    t, by = lloyd_round.least_seconds(b=1, n=2_097_152, k=4096, m=96)
    assert by == "ops, TF32"
    assert t == pytest.approx(2 * 2_097_152 * 4096 * 96 / 494.7e12)
    assert t == pytest.approx(3.334e-3, rel=1e-3)   # PERF.md's 3.334 ms


def test_kb_deep10m_pq_round_is_bound_by_bytes():
    t, by = lloyd_round.least_seconds(b=8, n=1_048_576, k=256, m=12)
    assert by == "bytes"
    assert t == pytest.approx(4 * (8 * 1_048_576 * 12 + 8 * 256 * 12
                                   + 8 * 256 + 8 * 1_048_576) / 3.35e12)
    assert t == pytest.approx(0.130e-3, rel=2e-3)   # PERF.md's 0.130 ms


def test_kc_sift_pq_round():
    t, by = lloyd_grouped.least_seconds(b=8, n=1_000_000, k=256, m=16)
    assert by == "bytes"
    assert t == pytest.approx(4 * (8e6 * 16 + 8 * 256 * 16 + 8 * 256 + 8e6)
                              / 3.35e12)
    assert t == pytest.approx(0.162e-3, rel=3e-3)   # PERF.md's 0.162 ms


def test_pass_reads_x_and_the_assignment_once():
    t, by = cluster_sums.least_seconds(b=1, n=2_097_152, k=4096, m=96)
    assert by == "bytes"
    assert t == pytest.approx(4 * (2_097_152 * 96 + 2_097_152 + 4096 * 96
                                   + 4096) / 3.35e12)
    assert t == pytest.approx(0.243e-3, rel=3e-3)   # PERF.md's 0.243 ms
