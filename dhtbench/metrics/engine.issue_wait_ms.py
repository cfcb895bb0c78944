"""Host time a round's issue half waits on the device: the totals of the
program's ``engine.sync_wait_us`` histograms of its three sites
(``capacity``, ``write_flag``, ``lock_rounds``) over the window's
``engine.rounds``, in ms."""

SITES = ("capacity", "write_flag", "lock_rounds")


def read(ctx):
    waits = [ctx.hists.get(f"engine.sync_wait_us.{s}", (0.0, 0))
             for s in SITES]
    rounds = ctx.counters.get("engine.rounds", 0)
    if not rounds or not any(n for _, n in waits):
        return None
    return sum(t for t, _ in waits) / rounds / 1e3
