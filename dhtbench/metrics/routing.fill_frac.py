"""Share of the routed lanes that carry a request (``estats["fill_frac"]``,
the program's ``engine.fill_frac`` histogram over the window), in %."""


def read(ctx):
    m = ctx.hist_mean("engine.fill_frac")
    return None if m is None else 100.0 * m
