"""The metric arithmetic on synthetic requests and spans: the rate, the
p90, the counters a round, and the trace's busy union, idle share and
breakdown."""
import pytest

from portbench import bench, harness, trace
from portbench.trace import Span


def req(start, end, sources=8, rounds=10, reads=11, traced=False):
    return harness.Request(start, end, sources, rounds, reads, traced)


def record(requests, summary=None):
    return harness.Record(setup_s=12.5, layout_build_s=4.25,
                          window_start=100.0, requests=requests,
                          trace=summary)


def read(name, rec):
    metric = bench.Metric(name, "x", "lower", "host_clock", None)
    return bench.reader(metric)(rec)


def test_rate_counts_sources_to_the_last_completion():
    rec = record([req(100.0, 101.0), req(101.0, 103.0, sources=4)])
    assert read("sources_per_s", rec) == pytest.approx(12 / 3.0)
    assert read("sources_per_s", record([])) is None


def test_p90_is_the_nearest_rank():
    times = [0.1 * k for k in range(1, 21)]           # 0.1 .. 2.0 s
    rec = record([req(0.0, t) for t in reversed(times)])
    assert read("solve_p90_ms", rec) == pytest.approx(1800.0)
    rec = record([req(0.0, t) for t in (0.3, 0.1, 0.2)])
    assert read("solve_p90_ms", rec) == pytest.approx(300.0)
    assert read("solve_p90_ms", record([])) is None


def test_setup_and_layout_are_read_from_the_record():
    rec = record([])
    assert read("setup_s", rec) == 12.5
    assert read("layout_build_s", rec) == 4.25


def test_counters_a_round_and_a_request():
    rec = record([req(0, 1, rounds=10, reads=11),
                  req(1, 2, rounds=30, reads=91)])
    assert read("rounds_per_request.rate", rec) == 20.0
    assert read("host_reads_per_round.latency", rec) == pytest.approx(
        102 / 40)
    assert read("host_reads_per_round.rate", record([])) is None


def test_busy_is_the_union_of_overlapping_device_spans():
    dev = [Span(0.0, 1.0, "a"), Span(0.5, 1.5, "b"), Span(2.0, 2.5, "a"),
           Span(2.1, 2.2, "c")]
    assert trace.merged(dev) == [(0.0, 1.5), (2.0, 2.5)]
    s = trace.summarize(dev, [], window_s=4.0)
    assert s.busy_s == pytest.approx(2.0)
    assert s.idle_share == pytest.approx(0.5)
    assert s.device_ops == 4
    assert s.top_ops[0][0] == "a" and s.top_ops[0][1] == pytest.approx(1.5)


def test_idle_gaps_go_to_the_innermost_host_op():
    dev = [Span(0.0, 1.0, "k"), Span(2.0, 3.0, "k"), Span(3.5, 4.0, "k"),
           Span(6.0, 7.0, "k")]
    host = [Span(0.5, 2.5, "aten::item"),
            Span(1.2, 1.9, "cudaStreamSynchronize"),
            Span(4.5, 4.9, "aten::index_select")]
    s = trace.summarize(dev, host, window_s=7.0)
    gaps = dict(s.idle_gaps)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(1.0)   # 1.0-2.0
    assert gaps[trace.BETWEEN_OPS] == pytest.approx(2.5)  # 3.0-3.5, 4-6
    assert s.idle_gaps[0][0] == trace.BETWEEN_OPS


def test_trace_metrics_read_the_summary():
    s = trace.summarize([Span(0.0, 1.0, "k"), Span(2.0, 3.0, "k")], [],
                        window_s=4.0)
    rec = record([req(0, 1, rounds=5, traced=True),
                  req(1, 2, rounds=5, traced=True),
                  req(2, 3, rounds=7)], summary=s)
    assert read("device_ops_per_round.rate", rec) == pytest.approx(0.2)
    assert read("idle_share.rate", rec) == pytest.approx(50.0)
    # nothing traced, or nothing ran on the device: nothing to read
    assert read("idle_share.rate", record([])) is None
    empty = trace.summarize([], [], window_s=4.0)
    assert read("idle_share.latency", record([], empty)) is None
    assert read("device_ops_per_round.latency", record([], empty)) is None
