"""A configuration, a traffic mix, a limits file and a per-layer metric are
each added by a new file alone: the harness finds them by the names in
BENCHMARK.json, with no edit of its code."""

import json
import shutil

from vobench import spec


def test_new_files_are_found_by_name(tmp_path):
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(spec.HERE / sub, tmp_path / sub)
    bench = json.load(open(spec.ROOT / "BENCHMARK.json"))
    cfg = json.load(open(tmp_path / "configs" / "kitti00-fast.json"))
    cfg["name"] = "euroc-mh"
    cfg["camera"] = {"fx": 458.654, "fy": 457.296, "cx": 367.215, "cy": 248.375,
                     "baseline": 0.110}
    json.dump(cfg, open(tmp_path / "configs" / "euroc-mh.json", "w"))
    traffic = json.load(open(tmp_path / "traffic" / "fleet8.json"))
    traffic["streams"] = 64
    json.dump(traffic, open(tmp_path / "traffic" / "fleet64.json", "w"))
    json.dump({"pose_gap_m": 0.5}, open(tmp_path / "limits" / "euroc-mh.fleet64.json", "w"))
    (tmp_path / "metrics" / "frames_seen.fleet.py").write_text(
        "def read(rec):\n    return float(len(rec['frames']))\n")
    bench["workloads"].append({"name": "euroc-mh.fleet64", "config": "euroc-mh",
                               "traffic": "fleet64", "chips": 1, "why": "a later cell"})
    next(m for m in bench["end_to_end"] if m["name"] == "frames_per_s")["workloads"].append(
        "euroc-mh.fleet64")
    bench["per_layer"].append({"name": "frames_seen.fleet", "unit": "frames",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "frames_per_s",
                               "workloads": ["euroc-mh.fleet64"]})

    cell = spec.load_cell("euroc-mh.fleet64", bench, root=tmp_path)
    assert cell.config["camera"]["fx"] == 458.654
    assert cell.traffic["streams"] == 64
    assert cell.limits == {"pose_gap_m": 0.5}
    assert [m["name"] for m in cell.end_to_end] == ["frames_per_s", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert "frames_seen.fleet" in names and "frame_host_ms.live" not in names
    assert spec.metric_reader("frames_seen.fleet", root=tmp_path)({"frames": [1, 2]}) == 2.0
    # the cells already there are untouched by the new entries
    old = spec.load_cell("kitti00-fast.fleet8", bench, root=tmp_path)
    assert "frames_seen.fleet" not in [m["name"] for m in old.per_layer]
