"""The whole decode step's share of the card's peak: the least time of
every frame step in the window (roofline/counts.frame_step at the active
lanes' cursors, in the configuration's formats) over the window's
length."""

from harness.readers import decode_mfu


def read(run):
    return decode_mfu(run)
