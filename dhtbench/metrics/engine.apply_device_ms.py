"""Device time of a round's shard pass (probe, checksum check, the write
schedule): the mean of the program's ``engine.device_us.apply``
histogram over the window, in ms."""


def read(ctx):
    us = ctx.hist_mean("engine.device_us.apply")
    return None if us is None else us / 1e3
