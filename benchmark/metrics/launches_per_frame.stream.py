"""Kernel launches in the traced stretch over the frames its decode calls
made (the calls wholly inside the stretch, and every kernel that started
between the first's start and the last's end)."""

from harness.readers import launches_per_frame


def read(run):
    return launches_per_frame(run)
