"""Write passes a round (``op_engine._apply_writes``: a ``shard_apply``
and a ``checksum`` launch and a flag read each), from the round's own
``estats["rounds"]``, over the window's rounds (each carries writes)."""


def read(ctx):
    xs = ctx.stat("write_passes")
    return sum(xs) / len(xs) if xs else None
