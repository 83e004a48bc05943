"""The reduction of a traced run's measurements, on made-up events."""

import pytest

from benchmark.harness import trace as T


def test_summarize_counts_kernels_calls_busy_and_gaps():
    ms = 1_000_000  # ns
    dev = [("kernel_a", 0, 2 * ms), ("Memcpy DtoD", 2 * ms, 3 * ms),
           ("kernel_b", 5 * ms, 6 * ms), ("kernel_a", 5 * ms, 7 * ms)]
    host = [("cudaGraphLaunch", 0, ms), ("aten::add", 3 * ms, 5 * ms),
            ("cudaLaunchKernel", 4 * ms, 4 * ms + 10),
            ("cudaLaunchKernelExC", 4 * ms + 20, 4 * ms + 30)]
    s = T.summarize(dev, host, wall_s=0.01, iterations=2)
    assert s["kernels"] == 3 and s["launch_calls"] == 3
    assert s["busy_s"] == pytest.approx(5e-3)
    assert s["span_s"] == pytest.approx(7e-3)
    assert s["window_s"] == 0.01 and s["iterations"] == 2
    assert s["device_s_by_name"]["kernel_a"] == pytest.approx(4e-3)
    assert s["idle_gaps"] == [("aten::add", pytest.approx(2e-3))]
    assert T.kernel_seconds(s, "kernel_b", "Memcpy") == pytest.approx(2e-3)
    assert T.device_ops(s)[0] == ["kernel_a", pytest.approx(4e-3)]


class _Event:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_replay_idle_share_counts_gaps_between_replays():
    spans = [(_Event(0.0), _Event(9.0)), (_Event(10.0), _Event(19.0))]
    assert T.replay_idle_share(spans) == pytest.approx(1 - 18 / 19)
    assert T.replay_idle_share(spans[:1]) is None
    assert T.block_gaps_ms([1.0, 1.5, 2.5]) == pytest.approx([500, 1000])


def test_sharded_ranks_aggregate_into_one_record():
    """Four ranks' traced records -> one: counts the most of any rank,
    kernel seconds summed for the rooflines, NCCL the most a rank."""
    from benchmark.drivers.sharded_blocks import _aggregate
    from benchmark.harness.spec import load_reader

    def rank(r):
        prof = dict(iterations=2, kernels=100 + r, launch_calls=5,
                    device_s_by_name={"ncclKernel_AllGather": 0.002 * r,
                                      "merge_cells_kernel": 1e-4,
                                      "intersect_sweep_kernel": 2e-4},
                    busy_s=0.1, span_s=0.1, window_s=0.2, idle_gaps=[])
        return dict(setup_s=30.0 + r, window_s=30.0, iterations=320,
                    peak_bytes=2 ** 30 + r, exchange_bytes=10 ** 9 + r,
                    block=2, block_gaps_ms=[186.0, 187.0, 190.0],
                    replay_idle_share=0.01 * (r + 1), syncs_per_block=1,
                    block_launch_calls=45, profiled_iteration=900,
                    profiled_rays=10 ** 7, first_merge_s=5e-5,
                    profile=prof,
                    **({"merge_counts": dict(queries=10 ** 6,
                                             photons=10 ** 6,
                                             candidates=10 ** 7)}
                       if r == 0 else {}))

    record, busy, span = _aggregate([rank(r) for r in range(4)], True)
    assert record["setup_s"] == 30.0 and record["world"] == 4
    assert record["peak_bytes"] == 2 ** 30 + 3
    assert record["profile"]["kernels"] == 103
    assert record["profile"]["device_s_by_name"]["merge_cells_kernel"] == \
        pytest.approx(4e-4)
    assert record["first_merge_s"] == pytest.approx(2e-4)
    assert record["nccl_s_per_iter"] == pytest.approx(0.003)
    assert record["replay_idle_share"] == pytest.approx(0.04)
    assert busy == pytest.approx(0.1) and span == 0.2
    read = {n: load_reader(n).read(record) for n in (
        "kernels_per_iter", "host_launch_calls_per_iter", "nccl_ms_per_iter",
        "exchange_mb_per_iter", "merge_roofline", "sweep_roofline",
        "idle_share.render", "block_ms_p90", "ms_per_iter", "peak_gib")}
    assert read["kernels_per_iter"] == 51.5
    assert read["host_launch_calls_per_iter"] == 22.5
    assert read["nccl_ms_per_iter"] == pytest.approx(3.0)
    assert read["exchange_mb_per_iter"] == pytest.approx(1e9 / 320 / 1e6)
    assert 0 < read["merge_roofline"] < 100 and 0 < read["sweep_roofline"]
    assert all(v is not None for v in read.values())
