"""Mean host-clock milliseconds of the graph + MPN stage
(`SequenceInferStep.track`, ending in a synchronise) per sequence."""


def read(ctx):
    if not ctx["stage_calls"] or "track" not in ctx["stage_s"]:
        return None
    return ctx["stage_s"]["track"] / ctx["stage_calls"] * 1e3
