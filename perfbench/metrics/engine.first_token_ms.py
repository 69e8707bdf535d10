"""Milliseconds from the start of the profiled ``serve`` call to its first
token on the host: the end of the first ``repro_torch.serve.fetch`` span
minus the start of the ``repro_torch.serve`` span (``repro_torch.
tracing``) that was open over the call's device activity.  Every
request of the batch gets its first token then.  Nothing when the call
ran nothing on the device or the program records no spans.  Layer: the
LM engine."""


def read(ctx):
    dev = (ctx.get("trace") or {}).get("device")
    if not dev:
        return None
    try:
        from repro_torch import tracing
    except ImportError:                 # a program that records no spans
        return None
    call = tracing.call_at(dev[len(dev) // 2][0], "repro_torch.serve")
    fetches = [s for s in call if s.name == "repro_torch.serve.fetch"]
    if not fetches:
        return None
    return (fetches[0].end_ns - call[0].start_ns) / 1e6
