"""Device milliseconds a profiled data-parallel training step spends in
the first rank's NCCL kernels (any kernel whose name holds "nccl": the
gradient all-reduce of `parallel/mesh.py:all_mean_grads`).  A kernel's
span takes in its wait for the slowest rank."""


def read(ctx):
    merged = ctx["merged"]
    seconds = sum(sec for name, (_, sec) in merged["kernels"].items()
                  if "nccl" in name.lower())
    if not seconds or not merged["calls"]:
        return None
    return seconds / merged["calls"] * 1e3
