"""The roofline arithmetic against PERF.md §6's recorded bounds."""

import pytest

from benchmark.roofline import merge, peaks, sweep


def test_peaks_are_the_h100_sxm_data_sheet():
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.F32_OPS_PER_S == 67e12


def test_closest_hit_bound_of_262144_random_rays():
    # PERF.md §6: 4.62 us, by operations (1,181.3 a ray); 9.4 MB = 2.8 us.
    n = 262144
    t, by = peaks.least_seconds(n * sweep.CLOSEST_BYTES,
                                n * sweep.CLOSEST_OPS_SCENE0)
    assert by == "operations"
    assert t == pytest.approx(4.62e-6, rel=2e-3)
    assert n * sweep.CLOSEST_BYTES == pytest.approx(9.4e6, rel=5e-3)
    assert n * sweep.CLOSEST_BYTES / peaks.HBM_BYTES_PER_S == \
        pytest.approx(2.8e-6, rel=2e-2)


def test_a_ray_is_priced_at_the_cheaper_entry():
    assert sweep.anyhit_seconds(1) < sweep.closest_seconds(1)
    assert sweep.least_seconds_for(10 ** 6) == \
        pytest.approx(10 ** 6 * 30 / 3.35e12)
    assert sweep.roofline_pct(10 ** 6, 10 ** 6 * 30 / 3.35e12) == \
        pytest.approx(100.0)
    assert sweep.roofline_pct(0, 1.0) is None
    assert sweep.roofline_pct(5, 0.0) is None


def test_merge_bound_counts_live_rows_below_the_cap_rows_bound():
    # PERF.md §5-6, the main path's iteration: 691,035 live queries of
    # 786,432 cap rows, 3,954,106 candidate pairs; the cap-row bound was
    # 30.22 us (101.2 MB). Live rows alone must bound lower.
    n_bytes, n_ops = merge.work(691035, 691035, 3954106)
    assert n_bytes == 4 * (3 + 15 * 691035 + 4 * 691035)
    assert n_ops == 9 * 3954106
    t, by = peaks.least_seconds(n_bytes, n_ops)
    assert by == "bytes" and t < 30.22e-6
    assert merge.roofline_pct(691035, 691035, 3954106, t) == \
        pytest.approx(100.0)


def test_sharded_merge_reads_every_photon_on_every_rank():
    one = merge.work(100, 50, 10)[0]
    four = merge.work(100, 50, 10, photon_reads=4)[0]
    assert four - one == 4 * 3 * (4 * 50 + 3)
