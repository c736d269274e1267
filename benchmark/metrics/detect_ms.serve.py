"""Mean host-clock milliseconds of the detector stage
(`SequenceInferStep.detect`, ending in a synchronise) per sequence."""


def read(ctx):
    if not ctx["stage_calls"] or "detect" not in ctx["stage_s"]:
        return None
    return ctx["stage_s"]["detect"] / ctx["stage_calls"] * 1e3
