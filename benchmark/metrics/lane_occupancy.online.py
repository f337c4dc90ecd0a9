"""lane_occupancy.online: frames delivered over the frames the window's
rounds could have made (rounds x lanes x frames a round)."""


def read(run):
    rounds = run.spans_named("serve.round")
    slots = sum(s[3]["lanes"] * s[3]["n"] for s in rounds)
    if not slots:
        return None
    return 100.0 * sum(s[3]["frames"] for s in rounds) / slots
