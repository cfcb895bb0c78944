"""Host synchronisations a round, counted by the program itself: its
``engine.host_syncs`` counter (one a timed host read of a device value)
over its ``engine.rounds``, over the window."""


def read(ctx):
    syncs = ctx.counters.get("engine.host_syncs")
    rounds = ctx.counters.get("engine.rounds", 0)
    return None if syncs is None or not rounds else syncs / rounds
