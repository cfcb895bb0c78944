"""The write pass's slot decision's share of its roofline
(``roofline/shard_apply.py``), in %."""


def read(ctx):
    return ctx.roofline_pct("shard_apply")
