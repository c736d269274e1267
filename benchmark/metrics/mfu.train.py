"""The whole training step's share of the card's TF32 dense peak: the
configuration's frozen FLOPs per step (forward and backward) times the
traced run's steps per second."""

from benchmark.common import PEAK_TF32_FLOPS


def read(ctx):
    flops = ctx["flops"].get("train_step_b%d" % ctx["traffic"]["batch"])
    if not flops or not ctx["rate"]:
        return None
    return flops * ctx["rate"] / PEAK_TF32_FLOPS * 100.0
