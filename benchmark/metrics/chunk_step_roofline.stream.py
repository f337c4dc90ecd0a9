"""chunk_step_roofline.stream: the chunk kernel (csrc/chunk_step.cu, one
launch per chunk of a stream) against the least time of its launch's work
(roofline/counts.chunk_call: every weight once, the lane's KV at its
cursor)."""

from harness.readers import formats, roofline
from roofline import counts

PATTERN = r"chunk_kernel"


def read(run):
    fmt, model = formats(run), run.config["model"]
    return roofline(run, PATTERN, lambda s: counts.chunk_call(
        model, fmt, s[3]["frames"], s[3]["cursor"]))
