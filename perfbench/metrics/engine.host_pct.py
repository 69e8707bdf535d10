"""The share of the window's ``serve`` calls' wall time spent outside
the program's prefill and decode calls (left padding, greedy choice,
host copies, the engine's loop), from the benchmark's wrappers, which
time each model call between two synchronizes.  Layer: the LM engine."""


def read(ctx):
    serve = sum(r["t1"] - r["t0"] for r in ctx["records"])
    model = sum(c[1] for c in ctx["model_calls"])
    if not serve or not ctx["model_calls"]:
        return None
    return 100.0 * (serve - model) / serve
