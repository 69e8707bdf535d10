"""The share of the profiled ``serve`` call's prompt slots (batch x the
longest prompt) that are left padding: 100 x (``prompt_slots`` -
``prompt_tokens``) / ``prompt_slots``, the counts of the program's
``repro_torch.serve`` span (``repro_torch.tracing``) that was open over
the call's device activity.  Nothing when the call ran nothing on the
device or the program records no spans.  Layer: the LM engine."""


def read(ctx):
    dev = (ctx.get("trace") or {}).get("device")
    if not dev:
        return None
    try:
        from repro_torch import tracing
    except ImportError:                 # a program that records no spans
        return None
    call = tracing.call_at(dev[len(dev) // 2][0], "repro_torch.serve")
    if not call:
        return None
    c = call[0].counts
    return 100.0 * (c["prompt_slots"] - c["prompt_tokens"]) / c["prompt_slots"]
