"""chunk_gap_p95_ms: time between successive audio chunks of a stream,
over every gap that lies in the window, 95th percentile."""

from harness.readers import percentile


def read(run):
    return percentile(((b - a) * 1e3 for r in run.extra["started"]
                       for a, b in r.gaps
                       if run.in_window(a) and run.in_window(b)), 95)
