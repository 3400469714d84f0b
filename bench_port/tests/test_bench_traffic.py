"""Every traffic mix is read and checked by the one reader."""

import pytest

from bench_port import traffic
from bench_port.spec import Spec


def test_every_mix_of_the_benchmark_reads():
    s = Spec()
    for w in s.doc["workloads"]:
        assert traffic.read(s.traffic(w["traffic"]))["loop"] in traffic.LOOPS
    for path in (s.here / "traffic").glob("*.json"):
        assert traffic.read(s.traffic(path.stem))["loop"] in traffic.LOOPS


COVER = {"every_frames": 300, "frames": [30, 60], "first_frame": 150}


def cover(**kw):
    return {"loop": "closed", "cover": dict(COVER, **kw)}


@pytest.mark.parametrize("mix", [
    {"loop": "sideways"}, {}, {"loop": "closed", "rate_hz": 30},
    cover(frames=[60, 30]), cover(frames=[0, 30]), cover(frames=[30]),
    cover(frames=[30.5, 60]), cover(every_frames=60),
    cover(every_frames=0), cover(first_frame=0), cover(first_frame=-5),
    cover(first_frame=True), cover(every_frames="300"),
    {"loop": "closed", "cover": {"every_frames": 300, "frames": [30, 60]}},
    {"loop": "closed", "cover": dict(COVER, hand="left")},
    {"loop": "closed", "limits": {"unrecovered": -1}},
    {"loop": "closed", "limits": [0.1]}])
def test_a_mix_the_reader_cannot_run_is_refused(mix):
    with pytest.raises(ValueError):
        traffic.read(mix)


EXPLORE = {"opening": 100, "frames": 1200}
ROUTE = {"kind": "route"}
ARC = {"radius": 0.5, "height": 0.9, "half_sweep_rad": 1.3}


def explore(**kw):
    return {"loop": "closed", "explore": dict(EXPLORE, **kw)}


def test_an_explore_mix_reads_on_a_route():
    assert traffic.read(explore(), ROUTE)["explore"] == EXPLORE
    assert traffic.read(explore()) == explore()


@pytest.mark.parametrize("mix", [
    {"loop": "closed", "explore": {"opening": 100}},
    {"loop": "closed", "explore": {"frames": 1200}},
    {"loop": "closed", "explore": dict(EXPLORE, revisit=True)},
    {"loop": "closed", "explore": [100, 1200]},
    explore(opening=0), explore(frames=0), explore(frames=-1200),
    explore(opening=2.5), explore(frames="1200"), explore(opening=True),
    dict(explore(), cover=COVER)])
def test_an_explore_mix_the_reader_cannot_run_is_refused(mix):
    with pytest.raises(ValueError):
        traffic.read(mix, ROUTE)


@pytest.mark.parametrize("mix, path", [
    (explore(), ARC), (explore(), dict(ARC, kind="arc")),
    ({"loop": "closed"}, ROUTE), ({"loop": "closed", "cover": COVER}, ROUTE)])
def test_a_mix_and_a_path_that_do_not_go_together_are_refused(mix, path):
    with pytest.raises(ValueError):
        traffic.read(mix, path)


def test_a_cover_schedule_follows_the_seed():
    a, b = (traffic.Covers(COVER, 3_000_000_017) for _ in range(2))
    lengths = [a.length(i) for i in range(40)]
    assert lengths == [b.length(i) for i in range(40)]
    assert min(lengths) >= 30 and max(lengths) <= 60 and len(set(lengths)) > 5
    assert lengths != [traffic.Covers(COVER, 3_000_000_018).length(i)
                       for i in range(40)]
    covered = [n for n in range(1000) if a.at(n)[1]]
    assert covered == [n for i in range(3) for n in range(
        150 + 300 * i, 150 + 300 * i + lengths[i])]
    assert traffic.Covers(None, 1).at(150) == (-1, False)


def test_a_mix_may_not_restate_a_configurations_limit(tmp_path):
    import json
    import shutil
    from bench_port import spec as speclib
    here = tmp_path / "bench_port"
    for d in ("configs", "traffic"):
        shutil.copytree(speclib.HERE / d, here / d)
    doc = json.loads((speclib.ROOT / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "tum_fr1_desk.covered",
                             "config": "tum_fr1_desk", "traffic": "covered",
                             "chips": 1, "why": "a cover mix"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    (here / "traffic" / "covered.json").write_text(json.dumps(
        dict(cover(), limits={"unrecovered": 0})))
    s = Spec(tmp_path, here)
    assert s.limits("tum_fr1_desk.covered") == dict(
        s.limits("tum_fr1_desk.offline"), unrecovered=0)
    (here / "traffic" / "covered.json").write_text(json.dumps(
        dict(cover(), limits={"rel_rot_max": 1.0})))
    with pytest.raises(ValueError):
        s.limits("tum_fr1_desk.covered")
