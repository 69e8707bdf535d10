"""The share of the profiled ``serve`` call's decode steps, the program's
``repro_torch.serve.decode_step`` spans (``repro_torch.tracing``), in
which no activity ran on the device: their summed time outside the
union of the device's activities, over their summed time.  It is read
at the spans' edges, so a drift of the profiler's device timestamps
from the host clock (PERF.md) moves busy time across them by as much.
In a traced run the benchmark's wrapper synchronizes around the model
call inside each step, and that wait is in the share.  Nothing when the
call ran nothing on the device, decoded no step, or the program records
no spans.  Layer: the model step, decode."""
from perfbench import trace as TR


def read(ctx):
    dev = (ctx.get("trace") or {}).get("device")
    if not dev:
        return None
    try:
        from repro_torch import tracing
    except ImportError:                 # a program that records no spans
        return None
    call = tracing.call_at(dev[len(dev) // 2][0], "repro_torch.serve")
    steps = [(s.start_ns, s.end_ns) for s in call
             if s.name == "repro_torch.serve.decode_step"]
    total = sum(e - s for s, e in steps)
    if not total:
        return None
    busy = sum(b - a for s, e in steps for a, b in TR._union(
        (max(a, s), min(b, e)) for a, b, _ in dev if b > s and a < e))
    return 100.0 * (total - busy) / total
