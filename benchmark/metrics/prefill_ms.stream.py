"""prefill_ms.stream: the engine's own prefill time of each stream
(last_metrics.prefill_ms, taken after a device synchronize), mean over the
requests completed in the window."""

import numpy as np


def read(run):
    vals = [r.prefill_ms for r in run.requests
            if run.in_window(r.t_done) and r.prefill_ms is not None]
    return float(np.mean(vals)) if vals else None
