"""frames_per_s: audio frames (80 ms each) that the cell's decode calls
(the online batcher's rounds) delivered in the window, over the window's
length."""


def read(run):
    rounds = run.spans_named(run.round)
    if not rounds:
        return None
    return sum(s[3]["frames"] for s in rounds) / run.seconds
