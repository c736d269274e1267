"""Kernels the card ran per served sequence in the traced span (the
profiler's kernel count, copies left out)."""


def read(ctx):
    calls = ctx["merged"]["calls"]
    if not calls:
        return None
    return sum(n for n, _ in ctx["merged"]["kernels"].values()) / calls
