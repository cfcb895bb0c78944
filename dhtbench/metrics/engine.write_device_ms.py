"""Device time of a round's write schedule inside its shard pass (the
write passes: ``shard_apply``, winner scatter, slab stores,
``checksum``): the mean of the program's ``engine.device_us.write``
histogram over the window, in ms."""


def read(ctx):
    us = ctx.hist_mean("engine.device_us.write")
    return None if us is None else us / 1e3
