"""The share of the rows computed by the profiled ``serve`` call's decode
steps whose request needed no more tokens: 100 x (sum ``rows`` - sum
``live_rows``) / sum ``rows`` over the program's
``repro_torch.serve.decode_step`` spans (``repro_torch.tracing``) of the
call that was open over the device activity.  Nothing when the call ran
nothing on the device, decoded no step, or the program records no
spans.  Layer: the LM engine."""


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
    rows = sum(c["rows"] for c in steps)
    if not rows:
        return None
    return 100.0 * (rows - sum(c["live_rows"] for c in steps)) / rows
