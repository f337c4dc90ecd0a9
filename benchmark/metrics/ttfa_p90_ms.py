"""ttfa_p90_ms: from the generate_stream call to its first audio chunk,
over every request called in the window whose first chunk came in it,
90th percentile."""

from harness.readers import percentile


def read(run):
    return percentile(((r.t_first - r.t_submit) * 1e3
                       for r in run.extra["started"]
                       if run.in_window(r.t_submit)
                       and run.in_window(r.t_first)), 90)
