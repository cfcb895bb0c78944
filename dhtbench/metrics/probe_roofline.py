"""The read probe's share of its roofline (``roofline/probe.py``), in %."""


def read(ctx):
    return ctx.roofline_pct("probe")
