"""Device activities (kernels, copies, sets) a decode step in the
profiled ``serve`` call, counted on the device's own timeline: those
after one step's copy of its tokens to the host, up to and including
the next step's, averaged over the steps.  A step's copy is the
``Memcpy DtoH`` activity whose end lies nearest the end of its
``repro_torch.serve.fetch`` span (``repro_torch.tracing``; the first is
the prefill's), where that fetch is also the copy's nearest.

So anchored, the count does not move with the profiler's device
timestamps, which drift from the host clock within a call (by up to
tens of ms, PERF.md): a drift carries activities across a span's edges,
not across a copy a whole step away.  A step whose copy fell outside
the traced window (``perfbench/trace.py`` keeps the activities inside
the window by their timestamps) has no anchor and is left out.  Every
activity of a step counts, the benchmark's own too: the loop's wrapper
gathers the sampled rows' logits in one activity a step.  Nothing when
the call ran nothing on the device, decoded no step, or the program
records no spans.  Layer: the model step, decode."""

COPY = "Memcpy DtoH"


def read(ctx):
    dev = (ctx.get("trace") or {}).get("device")
    if not dev:
        return None
    try:
        from repro_torch import tracing
    except ImportError:                 # a program that records no spans
        return None
    call = tracing.call_at(dev[len(dev) // 2][0], "repro_torch.serve")
    fetches = [s.end_ns for s in call if s.name == "repro_torch.serve.fetch"]
    copies = [i for i, a in enumerate(dev) if a[2].startswith(COPY)]
    if not copies:
        return None
    gap = lambda i, f: abs(dev[i][1] - f)
    anchors = []
    for f in fetches:
        i = min(copies, key=lambda i: gap(i, f))
        mutual = min(fetches, key=lambda g: gap(i, g)) == f
        anchors.append(i if mutual else None)
    steps = [b - a for a, b in zip(anchors, anchors[1:])
             if a is not None and b is not None]
    return sum(steps) / len(steps) if steps else None
