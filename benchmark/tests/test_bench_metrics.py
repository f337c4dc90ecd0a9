"""The end-to-end readers take all the window's work over all its time,
and every tail over all its samples: a stall injected into a synthetic
window moves them."""

import importlib.util

import pytest

from harness.runner import Run
from harness.traffic import Request
from tiny import BENCH


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def online_run(stall_at=None, stall=0.0):
    """Rounds of 0.1 s making 128 frames; requests of 1 s; a stall of
    `stall` s after the round at `stall_at`."""
    spans, reqs, t = [], [], 0.0
    for i in range(100):
        if stall_at is not None and i == stall_at:
            t += stall
        spans.append(("serve.round", t, t + 0.1,
                      {"frames": 128, "lanes": 32, "n": 4,
                       "cursors": [100] * 32}))
        t += 0.1
    for i in range(60):
        done = 0.5 + i * 0.15
        if stall_at is not None and done > stall_at * 0.1:
            done += stall
        r = Request(i, "x", "vivian", None, 48, False, 20)
        r.t_submit, r.t_done = done - 1.0, done
        reqs.append(r)
    return Run(workload={}, config={}, mix={"client": "online"},
               seconds=10.0 + stall, t0=0.0, t1=10.0 + stall, spans=spans,
               requests=reqs, round="serve.round")


def test_rate_is_all_work_over_all_time():
    base = reader("frames_per_s")(online_run())
    assert base == pytest.approx(100 * 128 / 10.0)
    slow = reader("frames_per_s")(online_run(stall_at=50, stall=2.0))
    assert slow == pytest.approx(100 * 128 / 12.0)


def test_latency_tail_sees_a_stall():
    base = reader("latency_p95_ms")(online_run())
    assert base == pytest.approx(1000.0)
    # a stall delays the requests in flight across it: their latency grows
    run = online_run()
    for r in run.requests[30:35]:
        r.t_done += 2.0
    assert reader("latency_p95_ms")(run) > 2000.0


def stream_run(stall=0.0):
    reqs, t = [], 0.0
    for i in range(20):
        r = Request(i, "x", "vivian", None, 16, False, 20)
        r.t_submit, r.t_first = t, t + 0.1
        gaps = [(t + 0.1 + 0.02 * k, t + 0.12 + 0.02 * k) for k in range(4)]
        if 10 <= i < 15:
            a, b = gaps[1]
            gaps[1] = (a, b + stall)
            r.t_first += stall
        r.gaps = gaps
        r.t_done = gaps[-1][1]
        reqs.append(r)
        t = r.t_done + 0.01
    run = Run(workload={}, config={}, mix={"client": "stream"},
              seconds=t, t0=0.0, t1=t, spans=[], requests=reqs,
              round="engine.chunk")
    run.extra["started"] = reqs
    return run


def test_stream_tails_see_a_stall():
    base_gap = reader("chunk_gap_p95_ms")(stream_run())
    assert base_gap == pytest.approx(20.0)
    base_ttfa = reader("ttfa_p90_ms")(stream_run())
    assert base_ttfa == pytest.approx(100.0)
    # five stalled gaps of 80 and five stalled first chunks of 20 lie
    # beyond the 95th and the 90th percentile
    run = stream_run(stall=1.0)
    assert reader("chunk_gap_p95_ms")(run) > base_gap
    assert reader("ttfa_p90_ms")(run) > base_ttfa


def test_occupancy_and_refill_share():
    run = online_run()
    run.spans.append(("serve.refill", 1.0, 1.5, {"lanes": 3, "rows": 90}))
    assert reader("lane_occupancy.online")(run) == pytest.approx(100.0)
    assert reader("refill_share.online")(run) == pytest.approx(5.0)
