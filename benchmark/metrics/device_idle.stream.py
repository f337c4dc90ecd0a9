"""Share of the traced stretch in which no kernel, copy or memset ran on
the card."""

from harness.readers import device_idle


def read(run):
    return device_idle(run)
