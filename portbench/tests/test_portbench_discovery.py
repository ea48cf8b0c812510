"""The harness finds a cell's files by the names in BENCHMARK.json: a
configuration, a traffic file, a check file and a metric added as files
are found and run without an edit to the harness."""

import json
import shutil

from conftest import ROOT, TINY

from portbench import core


def test_benchmark_names_resolve():
    bench = core.load_json(ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        _, _, c, config, traffic, limits = core.find_cell(ROOT, w["name"])
        assert (ROOT / "portbench" / "modes" / f"{traffic['mode']}.py").exists()
        assert "failed_units" in limits and "overflow" in limits
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()


def test_added_files_are_found(tmp_path, monkeypatch):
    """A new cell and metric, added as files only, run through run_cell."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = core.load_json(ROOT / "BENCHMARK.json")
    bench["workloads"].append({"name": "qg2_512.tiny", "config": "qg2_512",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "test.units", "unit": "units", "better": "higher",
        "source": "host_clock", "layer": "entry", "moves":
        "packet_steps_per_s", "workloads": ["qg2_512.tiny"]})
    for m in bench["end_to_end"]:
        if m["name"] == "packet_steps_per_s":
            m["workloads"].append("qg2_512.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    here = core.HERE
    traffic = core.merged(core.load_json(here / "traffic" / "p1m.json"),
                          TINY["qg2_512.p1m"]["traffic"])
    (root / "portbench" / "traffic" / "tiny.json").write_text(
        json.dumps(traffic))
    shutil.copy(here / "checks" / "qg2_512.p1m.json",
                root / "portbench" / "checks" / "qg2_512.tiny.json")
    (root / "portbench" / "metrics" / "test.units.py").write_text(
        "def read(rec):\n    return rec['window']['units']\n")
    monkeypatch.setattr(core, "HERE", root / "portbench")
    over = {"config": TINY["qg2_512.p1m"]["config"]}
    for trace, names in ((False, {"setup_s", "packet_steps_per_s"}),
                         (True, {"test.units"})):
        r = core.run_cell(root, "qg2_512.tiny", 7, 0.2, trace, "cpu", 0.0,
                          overrides=over)
        assert r["correct"], r["checks"]
        assert names <= set(r["metrics"]), r["metrics"]


def test_held_cells_resolve(bench_root):
    """A held cell's entries, added to BENCHMARK.json, find its files."""
    held = core.load_json(ROOT / "portbench" / "held.json")
    bench = core.load_json(ROOT / "BENCHMARK.json")
    assert held["workloads"]
    names = {w["name"] for w in bench["workloads"]}
    for w in held["workloads"]:
        assert w["name"] not in names
        _, _, c, config, traffic, limits = core.find_cell(bench_root,
                                                          w["name"])
        assert c["name"] == w["config"] and "failed_units" in limits
