"""latency_p95_ms: submit to result of every request completed in the
window, 95th percentile."""

from harness.readers import percentile


def read(run):
    return percentile(((r.t_done - r.t_submit) * 1e3 for r in run.requests
                       if run.in_window(r.t_done) and r.error is None), 95)
