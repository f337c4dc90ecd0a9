"""talker_step_roofline.online: the talker decode step's kernels
(csrc/talker_step.cu's step kernel and the lane-append kernel after it)
against the least time of their work: per round, one talker step a frame
over the active lanes at their cursors (roofline/counts.talker_step)."""

from harness.readers import formats, roofline, step_cursors
from roofline import counts

PATTERN = r"step_kernel|append_lanes_kernel"


def read(run):
    fmt, model = formats(run), run.config["model"]

    def bound(span):
        ops = by = 0.0
        for cur in step_cursors(span):
            o, b = counts.talker_step(model, fmt, cur)
            ops, by = ops + o, by + b
        return ops, by

    return roofline(run, PATTERN, bound)
