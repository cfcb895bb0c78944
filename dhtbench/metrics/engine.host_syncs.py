"""Host synchronisations a round: the program's stream and event waits
and blocking copies over the profiled rounds (torch.profiler's CUDA
runtime events)."""


def read(ctx):
    return ctx.per_round("host_syncs")
