"""Share of the traced span in which nothing of any client ran on the
card: 1 minus the union of every client's kernel and copy spans, on one
timeline, over the span all clients profiled."""


def read(ctx):
    if not ctx["window_s"] or ctx["occupancy"] is None:
        return None
    return (1.0 - ctx["occupancy"]) * 100.0
