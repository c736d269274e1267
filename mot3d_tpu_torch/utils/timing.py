"""Time formatting (counterpart of `mot3d_tpu/utils/timing.py`;
`Tracking/utils/train_utils.py:178-195`)."""


def sec_to_hm_str(t: float) -> str:
    """10239 -> '02h50m39s'."""
    t = int(t)
    s = t % 60
    t //= 60
    m = t % 60
    return f"{t // 60:02d}h{m:02d}m{s:02d}s"
