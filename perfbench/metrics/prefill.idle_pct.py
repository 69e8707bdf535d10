"""The share of the profiled ``serve`` call's prefill, the program's
``repro_torch.serve.prefill`` span (``repro_torch.tracing``: the model's
prefill, the first greedy choice and its fetch), in which no activity
ran on the device.  It is read at the span's edges, so a drift of the
profiler's device timestamps from the host clock (PERF.md) moves busy
time across them by as much.  Nothing when the call ran nothing on the
device or the program records no spans.  Layer: the model step,
prefill."""
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
    pre = [(p.start_ns, p.end_ns) for p in call
           if p.name == "repro_torch.serve.prefill"]
    if not pre:
        return None
    s, e = pre[0]
    busy = sum(b - a for a, b in TR._union(
        (max(a, s), min(b, e)) for a, b, _ in dev if b > s and a < e))
    return 100.0 * (e - s - busy) / (e - s)
