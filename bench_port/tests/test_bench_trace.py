"""The device idle share is the union of every stream's activity; a kernel
is the mapping layer's when its launch falls inside a MapMaker.step span."""

import pytest

from bench_port import trace as tracelib
from bench_port.trace import Activity, Spans, Trace


def act(start, end, launch=None, name="k"):
    return Activity(name=name, start=start, end=end, kernel=True,
                    launch_t=launch)


def test_union_over_overlapping_streams():
    # Two streams' activities, overlapping each other.
    acts = [act(10, 30), act(20, 40), act(35, 50), act(70, 80),
            act(75, 78), act(95, 120)]
    busy, gaps = tracelib.union_seconds(acts, 0, 100)
    # [10, 50] + [70, 80] + [95, 100], clipped to the window.
    assert busy == pytest.approx((40 + 10 + 5) / 1e9)
    assert gaps == [(0, 10), (50, 70), (80, 95)]
    assert tracelib.union_seconds([], 0, 100) == (0.0, [(0, 100)])


def test_kernels_are_placed_by_their_launch():
    spans = Spans()
    spans.add(tracelib.FRAME, 0, 100)
    spans.add(tracelib.STEP, 60, 90)
    spans.add(tracelib.FRAME, 100, 200)
    spans.add(tracelib.STEP, 150, 160)
    acts = [act(5, 50, launch=2), act(70, 95, launch=61),
            act(96, 130, launch=90), act(131, 140, launch=91),
            act(150, 170, launch=155), act(171, 175, launch=None)]
    tr = Trace(0, 200, acts)
    track, mapping, unplaced = tracelib.attribute(tr, spans)
    assert [a.launch_t for a in mapping] == [61, 90, 155]
    assert [a.launch_t for a in track] == [2, 91, None]
    assert unplaced == 1


def test_breakdown_names_gaps_by_what_the_host_did():
    spans = Spans()
    spans.add(tracelib.FRAME, 0, 1_000_000)
    spans.add(tracelib.STEP, 500_000, 900_000)
    acts = [act(0, 100_000, name="a"), act(200_000, 300_000, name="b"),
            act(300_000, 310_000, name="a"),
            act(600_000, 700_000, name="b")]
    b = tracelib.breakdown(Trace(0, 2_000_000, acts), spans)
    assert b["device_ops"] == [["b", 200_000 / 1e9], ["a", 110_000 / 1e9]]
    names = [n for n, _ in b["idle_gaps"]]
    assert names[0].startswith("MapMaker.step@0.700")  # 700 us to 2 ms
    assert names[1].startswith("process_frame@0.310")
    assert names[2].startswith(tracelib.FRAME)      # 100 to 200 us
    assert b["idle_gaps"][0][1] == pytest.approx(1.3e-3)
