"""The join of the program's spans with a device trace (`spans.py`), on
synthetic profiles: a kernel belongs to the innermost span open at its
launch, whatever thread launched it; idle gaps are named by the span open
at their midpoint; the readers' helpers give per-occurrence values, or
None where their span never ran."""

from __future__ import annotations

import pytest

from benchmark import spans

US = 1000      # ns in a microsecond


def _rec(i, name, start, end, parent=None, counts=None):
    return {"name": name, "id": i, "parent": parent,
            "start_ns": start * US, "end_ns": end * US,
            "counts": counts or {}}


# One served sequence: times in microseconds.
SEQUENCE = [
    _rec(0, "sequence", 0, 1000),
    _rec(1, "detect", 100, 600, 0),
    _rec(2, "detect.heads", 400, 600, 1),
    _rec(3, "pose", 600, 800, 0),
    _rec(4, "upload", 650, 700, 3, counts={"h2d_bytes": 4000}),
    _rec(5, "track", 800, 900, 0),
    _rec(6, "upload", 820, 830, 5, counts={"h2d_bytes": 1000}),
]
# (name, device start, device end, correlation) and launch times.
DEVICE = [("gemm", 2000, 2010, 11), ("heads_conv", 2100, 2120, 12),
          ("Memcpy HtoD (Pageable -> Device)", 2200, 2230, 13),
          ("tail", 2300, 2305, 14), ("lost", 2400, 2401, 15),
          ("after", 2500, 2507, 16)]
LAUNCH = {11: 150, 12: 450, 13: 660, 14: 950, 16: 1500}


def _timeline():
    return spans.build([(n, s * US, e * US, c) for n, s, e, c in DEVICE],
                       {c: t * US for c, t in LAUNCH.items()}, SEQUENCE)


def test_bench_kernel_goes_to_the_innermost_span():
    tl = _timeline()
    owner = spans.innermost(tl, tl["launch"])
    assert [tl["name"][i] if i >= 0 else None for i in owner] == [
        "detect", "detect.heads", "upload", "sequence", None, None]


def test_bench_backward_kernel_from_another_thread_lands_in_backward():
    """autograd's device thread launches the gradient's kernel at 250 while
    the caller's thread waits inside `train.backward`: the join goes by
    the launch's time in the process, whatever its thread."""
    records = [_rec(0, "train.forward", 0, 100),
               _rec(1, "train.backward", 100, 400),
               _rec(2, "train.optimizer", 400, 500)]
    device = [("wgrad2d_grouped_direct_kernel", 300 * US, 380 * US, 7),
              ("sm90_gemm", 30 * US, 90 * US, 8),
              ("adamw", 430 * US, 440 * US, 9)]
    launch = {7: 250 * US, 8: 20 * US, 9: 420 * US}
    tls = [spans.build(device, launch, records)]
    per = "train.forward"
    assert spans.device_ms(tls, "train.backward", per) == \
        pytest.approx(0.080)
    assert spans.device_ms(tls, "train.forward", per) == \
        pytest.approx(0.060)
    assert spans.device_ms(tls, "train.optimizer", per) == \
        pytest.approx(0.010)


@pytest.mark.parametrize("t, key, expected", [
    (50.0, "track:outer", "track:outer"),            # before every span
    (800.0, "track:outer", "track/track:outer"),
    (680.0, "track:aten::copy_", "track/upload:aten::copy_"),
    (950.0, "outside:no op", "outside:no op"),       # after every span
])
def test_bench_gap_is_named_by_label_span_and_op(t, key, expected):
    """An idle gap's midpoint inside a program span adds the innermost
    one to its name; outside every span the name stays `label:op`."""
    tl = spans.build([], {}, [_rec(0, "track", 600, 900),
                              _rec(1, "upload", 640, 720, 0)])
    assert spans.gap_name(tl, t, key) == expected


@pytest.mark.parametrize("reader, expected", [
    (lambda t: spans.device_ms(t, "detect", "sequence"), 0.030),
    (lambda t: spans.device_ms(t, "detect.heads", "sequence"), 0.020),
    (lambda t: spans.device_ms(t, "pose", "sequence"), 0.030),
    (lambda t: spans.device_ms(t, "track", "sequence"), 0.0),
    (lambda t: spans.device_ms(t, "sequence", "sequence"), 0.065),
    (lambda t: spans.launches(t, "sequence", "sequence"), 3),
    (lambda t: spans.host_ms(t, "upload", "sequence"), 0.060),
    (lambda t: spans.counter(t, "h2d_bytes", "upload", "sequence"), 5000),
    (lambda t: spans.device_ms(t, "detect.absent", "sequence"), None),
    (lambda t: spans.host_ms(t, "train.forward", "train.upload"), None),
    (lambda t: spans.counter(t, "h2d_bytes", "upload", "absent"), None),
])
def test_bench_span_readers(reader, expected):
    """Each helper over two processes' timelines of one sequence each:
    values per sequence, None where the span (or the divisor) is
    absent."""
    got = reader([_timeline(), _timeline()])
    if expected is None:
        assert got is None
    else:
        assert got == pytest.approx(expected)
