"""The traced window: a stretch in which the profiler recorded no kernel
is taken again while a whole stretch still fits, and the profiler starts
and stops with the device lock held."""

import threading
import time

import pytest

from harness import runner, trace


class FakeTracer:
    def __init__(self, kernels):
        self.counts = list(kernels)
        self.tries = 0
        self.log = []

    def start(self):
        self.tries += 1
        self.log.append("start")

    def stop(self):
        self.log.append("stop")

    def kernels(self):
        return self.counts[self.tries - 1]


class TickClient:
    """Calls tick() when it asks, as the clients' drive() does."""

    def drive(self, t_end, tick):
        while time.perf_counter() < t_end:
            wake = min(t_end, tick())
            time.sleep(max(0.0, wake - time.perf_counter()))


@pytest.mark.parametrize("kernels, at, tries", [
    ([7], 0.1, 1),              # kernels in the first stretch
    ([0, 5], 0.1, 2),           # none in the first: taken again
    ([0, 0, 0], 0.1, 3),        # never: TRACE_TRIES stretches, no more
    ([0, 5], 0.8, 1),           # none, and no whole stretch fits after
])
def test_stretch_without_kernels_is_taken_again(kernels, at, tries, capsys):
    tracer = FakeTracer(kernels)
    t0, t1 = runner.window(TickClient(), {"trace_at": at, "trace_s": 0.05},
                           0.5, tracer)
    assert tracer.tries == tries
    assert tracer.log == ["start", "stop"] * tries
    assert 0.45 <= t1 - t0 <= 0.6
    assert capsys.readouterr().err.count("recorded no kernel") == \
        sum(1 for k in kernels[:tries] if k == 0)


def test_tracer_starts_and_stops_under_the_lock(monkeypatch):
    """No other thread may hold the lock while the profiler starts or
    stops."""
    held = []

    class Lock:
        def __enter__(self):
            held.append(True)

        def __exit__(self, *exc):
            held.append(False)

    class Prof:
        def __init__(self, **kw):
            pass

        def start(self):
            assert held[-1] is True
            calls.append("start")

        def stop(self):
            assert held[-1] is True
            calls.append("stop")

    calls = []
    monkeypatch.setattr("torch.profiler.profile", Prof)
    monkeypatch.setattr("torch.cuda.synchronize", lambda *a: None)
    tr = trace.Tracer(Lock())
    tr.start()
    tr.stop()
    tr.start()
    assert calls == ["start", "stop", "start"]
    assert tr.tries == 2 and held == [True, False] * 3


def test_tracer_takes_a_real_lock():
    lock = threading.RLock()
    tr = trace.Tracer(lock)
    assert tr.lock is lock
    assert trace.Tracer().lock is not None
