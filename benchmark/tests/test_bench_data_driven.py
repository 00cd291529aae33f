"""The harness finds a new traffic mix and a new per-layer metric by name,
from files added beside the others, with no existing file edited."""
import json
import os
import shutil
import types

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_new_traffic_and_metric_found_by_name(tmp_path):
    base = tmp_path / "bench"
    shutil.copytree(os.path.join(BENCH, "traffic"), base / "traffic")
    shutil.copytree(os.path.join(BENCH, "metrics"), base / "metrics")
    before = {p: (base / "traffic" / p).read_bytes() for p in os.listdir(base / "traffic")}
    t = json.loads((base / "traffic" / "kitti-b6-train.json").read_text())
    t.update(points_per_frame=40000, objects=12)
    (base / "traffic" / "kitti-b6-dense.json").write_text(json.dumps(t))
    (base / "metrics" / "frames_per_step.py").write_text(
        "def read(ctx):\n    return None if not ctx.events else float(ctx.frames)\n")
    bench = harness.spec()
    wl = {"name": "second-kitti-3class.dense-train", "config": "second-kitti-3class",
          "traffic": "kitti-b6-dense", "chips": 1, "why": "test"}
    bench["workloads"].append(wl)
    cfg, traffic, limits = harness.cell_parts(wl, bench, str(base))
    assert cfg["family"] == "second" and traffic["points_per_frame"] == 40000
    assert harness.entry_class(traffic).__module__ == "benchmark.entries.train_inline"
    assert limits == {}
    reader = harness.metric_reader("frames_per_step.train", str(base / "metrics"))
    assert reader.read(types.SimpleNamespace(events=[1], frames=6)) == 6.0
    assert harness.metric_reader("idle_share.eval", str(base / "metrics")).read(
        types.SimpleNamespace(events=[1], window_us=100.0, busy_us=25.0)) == 75.0
    assert {p: (base / "traffic" / p).read_bytes() for p in before} == before


def test_every_listed_metric_has_a_reader():
    bench = harness.spec()
    for m in bench["per_layer"]:
        assert hasattr(harness.metric_reader(m["name"]), "read")
    for w in bench["workloads"]:
        cfg, traffic, _ = harness.cell_parts(w, bench)
        assert os.path.isfile(os.path.join(BENCH, "program", cfg["family"] + ".py"))
        assert os.path.isfile(os.path.join(BENCH, "reference", cfg["family"] + ".py"))
        assert os.path.isfile(os.path.join(BENCH, "entries", traffic["entry"] + ".py"))
