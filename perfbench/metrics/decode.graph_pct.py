"""The share of the profiled ``serve`` call's decode steps that replayed
a captured CUDA graph: 100 x the sum of the ``graph`` counts over the
number of the program's ``repro_torch.serve.decode_step`` spans
(``repro_torch.tracing``) of the call that was open over the device
activity.  Nothing when the call ran nothing on the device, decoded no
step, or the program records no spans or no ``graph`` count.  Layer:
the model step, decode."""


def read(ctx):
    dev = (ctx.get("trace") or {}).get("device")
    if not dev:
        return None
    try:
        from repro_torch import tracing
    except ImportError:                 # a program that records no spans
        return None
    call = tracing.call_at(dev[len(dev) // 2][0], "repro_torch.serve")
    steps = [s.counts for s in call
             if s.name == "repro_torch.serve.decode_step"]
    if not steps or any("graph" not in c for c in steps):
        return None
    return 100.0 * sum(c["graph"] for c in steps) / len(steps)
