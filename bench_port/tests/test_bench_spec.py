"""Every cell, configuration, traffic mix and metric is found by name from
a file of its own, and a new one is picked up without editing any file."""

import json
import shutil

from bench_port import spec as speclib
from bench_port.spec import Spec


def test_every_entry_has_its_file():
    s = Spec()
    doc = s.doc
    for c in doc["configs"]:
        cfg = s.config(c["name"])
        assert cfg["name"] == c["name"]
        assert set(cfg["limits"]) and cfg["reduced"] == c["reduced"]
    names = {m["name"] for m in doc["end_to_end"] + doc["per_layer"]}
    for w in doc["workloads"]:
        s.cell(w["name"])
        assert s.traffic(w["traffic"])["loop"] in ("open", "closed")
        e2e = s.metrics(w["name"], False)
        layer = s.metrics(w["name"], True)
        assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2
        assert layer
        reported = {m["name"] for m in e2e}
        for m in layer:
            assert m["moves"] in reported
    for n in names:
        assert callable(s.reader(n))


def test_a_new_cell_traffic_and_metric_need_no_edit(tmp_path):
    here = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(speclib.HERE / d, here / d)
    doc = json.loads((speclib.ROOT / "BENCHMARK.json").read_text())
    (here / "traffic" / "replay.json").write_text(json.dumps(
        {"loop": "closed"}))
    (here / "metrics" / "frames_seen.py").write_text(
        "def read(ctx):\n    return ctx['frames']\n")
    (here / "metrics" / "frames_seen.offline.py").write_text(
        "def read(ctx):\n    return ctx['frames']\n")
    doc["workloads"].append({"name": "tum_fr1_desk.replay",
                             "config": "tum_fr1_desk", "traffic": "replay",
                             "chips": 1, "why": "a new mix"})
    doc["end_to_end"].append({"name": "frames_seen", "unit": "frames",
                              "better": "higher", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": ["tum_fr1_desk.replay"]})
    doc["per_layer"].append({"name": "frames_seen.offline",
                             "unit": "frames", "better": "higher",
                             "source": "host_clock", "layer": "engine",
                             "moves": "setup_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    s = Spec(tmp_path, here)
    assert s.traffic(s.cell("tum_fr1_desk.replay")["traffic"]) == {
        "loop": "closed"}
    assert [m["name"] for m in s.metrics("tum_fr1_desk.replay", False)] == [
        "setup_s", "frames_seen"]
    # A metric without ``workloads`` goes to every cell that reports what
    # it moves: setup_s, which every cell reports.
    for cell in ("tum_fr1_desk.offline", "tum_fr1_desk.replay"):
        assert "frames_seen.offline" in [
            m["name"] for m in s.metrics(cell, True)]
    assert s.reader("frames_seen")({"frames": 7}) == 7
    assert s.reader("frames_seen.offline")({"frames": 8}) == 8


def test_a_metric_without_workloads_follows_what_it_moves(tmp_path):
    doc = json.loads((speclib.ROOT / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "tum_fr1_desk.replay",
                             "config": "tum_fr1_desk", "traffic": "offline",
                             "chips": 1, "why": "a new cell"})
    doc["end_to_end"].append({"name": "frames_seen", "unit": "frames",
                              "better": "higher", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": ["tum_fr1_desk.replay"]})
    doc["per_layer"].append({"name": "seen_share", "unit": "%",
                             "better": "higher", "source": "host_clock",
                             "layer": "engine", "moves": "frames_seen"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    s = Spec(tmp_path)
    assert "seen_share" in [m["name"] for m in
                            s.metrics("tum_fr1_desk.replay", True)]
    assert "seen_share" not in [m["name"] for m in
                                s.metrics("tum_fr1_desk.offline", True)]
