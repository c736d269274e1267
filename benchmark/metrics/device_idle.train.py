"""Share of the traced span of training steps in which nothing ran on
the card: 1 minus the profiler's busy time over the span's wall time."""


def read(ctx):
    if not ctx["window_s"] or ctx["occupancy"] is None:
        return None
    return (1.0 - ctx["occupancy"]) * 100.0
