"""Device time of a round's binning phase (hash, placement, capacity
plan, sort binning, lane payloads): the mean of the program's
``engine.device_us.bin`` histogram over the window, in ms."""


def read(ctx):
    us = ctx.hist_mean("engine.device_us.bin")
    return None if us is None else us / 1e3
