"""The whole serving step's share of the card's TF32 dense peak: the
configuration's frozen FLOPs per sequence times the traced run's
sequences per second."""

from benchmark.common import PEAK_TF32_FLOPS


def read(ctx):
    flops = ctx["flops"].get("serve_sequence")
    if not flops or not ctx["rate"]:
        return None
    return flops * ctx["rate"] / PEAK_TF32_FLOPS * 100.0
