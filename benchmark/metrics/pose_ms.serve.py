"""Mean host-clock milliseconds of the pose stage
(`SequenceInferStep.pose`, ending in a synchronise) per sequence."""


def read(ctx):
    if not ctx["stage_calls"] or "pose" not in ctx["stage_s"]:
        return None
    return ctx["stage_s"]["pose"] / ctx["stage_calls"] * 1e3
