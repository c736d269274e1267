"""K3's share of its roofline, read where it runs alone: after the window
one client profiles a few calls while the others wait (`serve.SOLO_CALLS`),
since in the window four processes time-slice the card and a kernel's
span takes in the others' time.  The least time those calls' work needs
(`counts.k3_work` on each call's own inputs, against the published fp32 and
HBM peaks) over the profiler's device time of the kernels named
`nms_kernel`."""

from benchmark.counts import bound_s

KERNEL = "nms_kernel"


def read(ctx):
    solo = ctx.get("solo")
    if not solo:
        return None
    dev_s = sum(sec for name, (_, sec) in solo["kernels"].items()
                if KERNEL in name)
    work = solo["work"].get("k3")
    if not dev_s or not work or not work["calls"]:
        return None
    return bound_s(work["ops"], work["bytes"]) / dev_s * 100.0
