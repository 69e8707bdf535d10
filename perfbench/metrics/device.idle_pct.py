"""The share of the profiled ``serve`` call in which no operation ran on
the device (``trace``: the union of the device's activities against the
call's host span).  Layer: device."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("window_s") or not t.get("device"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
