"""Mean ms of the window's decode calls (each timed between two
synchronizes).  Layer: the model step, decode."""


def read(ctx):
    calls = [c for c in ctx["model_calls"] if c[0] == "decode_step"]
    return 1e3 * sum(c[1] for c in calls) / len(calls) if calls else None
