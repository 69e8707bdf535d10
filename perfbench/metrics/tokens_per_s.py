"""Real tokens a second: the prompt tokens (left padding not counted) and
the generated tokens of every request completed in the window, over the
window's seconds (from the first call's start to the last call's
return)."""


def read(ctx):
    return ctx["tokens"] / ctx["window_s"] if ctx["tokens"] else None
