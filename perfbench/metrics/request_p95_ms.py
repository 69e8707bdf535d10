"""The 95th percentile (nearest rank) over every request completed in
the window of its time from the start of the ``serve`` call that carried
it to that call's return, in ms."""
import math


def read(ctx):
    lat = sorted(ctx["latencies_s"])
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
