"""Share of the profiled window in which no operation ran on the card
(the trace unfenced), in %."""


def read(ctx):
    p = ctx.profile
    if not p.get("window_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
