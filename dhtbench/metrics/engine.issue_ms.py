"""Median host time of a round's issue half (``dht_issue``): the
program's own ``InFlightRound.telemetry["issue_us"]``, in ms."""


def read(ctx):
    us = ctx.median("issue_us")
    return None if us is None else us / 1e3
