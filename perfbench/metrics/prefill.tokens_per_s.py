"""Padded tokens computed by the window's prefill calls over their summed
time (each timed between two synchronizes).  Layer: the model step,
prefill."""


def read(ctx):
    calls = [c for c in ctx["model_calls"] if c[0] == "prefill"]
    secs = sum(c[1] for c in calls)
    return sum(c[2] * c[3] for c in calls) / secs if secs else None
