"""refill_share.online: share of the window spent inside the batcher's
prefills of new lanes (Generator.refill_lanes, and the cold start)."""


def read(run):
    spans = (run.spans_named("serve.refill")
             + run.spans_named("serve.cold_start"))
    if not run.spans_named("serve.round"):
        return None
    return 100.0 * sum(s[2] - s[1] for s in spans) / run.seconds
