"""Device time of a round's two exchange legs (``route_pack`` out,
``route_unpack`` back): the means of the program's
``engine.device_us.dispatch`` and ``engine.device_us.collect``
histograms over the window, summed, in ms."""


def read(ctx):
    out = ctx.hist_mean("engine.device_us.dispatch")
    back = ctx.hist_mean("engine.device_us.collect")
    return None if out is None or back is None else (out + back) / 1e3
