"""Seconds from the process's start to the window's: imports, loading
(or building) the kernel library, drawing the weights, the warm-up."""


def read(ctx):
    return ctx.get("setup_s")
