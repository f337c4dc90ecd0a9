"""predictor_frame_roofline.online: the predictor-frame kernel
(csrc/predictor_frame.cu) against the least time of its work: per round,
one frame a step over the active lanes (roofline/counts.predictor_frame)."""

from harness.readers import formats, roofline, step_cursors
from roofline import counts

PATTERN = r"frame_kernel"


def read(run):
    fmt, model = formats(run), run.config["model"]

    def bound(span):
        ops = by = 0.0
        for cur in step_cursors(span):
            o, b = counts.predictor_frame(model, fmt, len(cur))
            ops, by = ops + o, by + b
        return ops, by

    return roofline(run, PATTERN, bound)
