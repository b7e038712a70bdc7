"""`BENCHMARK.json` against the contract's shapes, and a cell added as new
files and entries only, found by name with no edit to an existing file."""

import json
import re
import shutil
import statistics

import pytest

from benchmark import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    with open(manifest.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(m):
    assert set(m) == KEYS
    assert 1 <= len(m["command"]) <= 32 and all(_line(w) for w in
                                                 m["command"])
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits in its 43,200 s
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(m).encode()) <= 64 * 1024


def test_names_units_and_keys(m):
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert c["file"].startswith(m["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and x["name"] not in names
        names.add(x["name"])
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert x["source"] in SOURCES
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(x["layer"])
    assert len({c["name"] for c in m["configs"]}) == len(m["configs"])
    assert len({w["name"] for w in m["workloads"]}) == len(m["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_cell_reports_what_it_must(m):
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])
    for w in m["workloads"]:
        cell = manifest.load(w["name"])
        e2e = {x["name"] for x in cell.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = cell.per_layer()
        assert layer
        for x in layer:
            assert x["moves"] in e2e
        assert set(cell.readers()) == {x["name"] for x in layer}
        assert cell.driver().run


def test_layer_names_are_one_spelling(m):
    by_base = {}
    for x in m["per_layer"]:
        by_base.setdefault(x["name"].split(".")[0], set()).add(x["layer"])
    assert all(len(v) == 1 for v in by_base.values())


def test_bounds_follow_the_rule_of_five(m):
    """Every end-to-end bound but set-up's is at least 1 %."""
    bounds = [x["bound"] for x in m["end_to_end"] if x["name"] != "setup_s"]
    assert min(bounds) >= 0.01 and statistics.mean(bounds) <= 0.25


def test_a_cell_added_as_files_only(tmp_path, m):
    """A new configuration, traffic mix, per-layer metric and cell: new
    files and new entries; the harness finds each by name."""
    root = tmp_path
    shutil.copytree(manifest.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    with open(manifest.ROOT / "benchmark" / "configs"
              / "bdm-blending.json") as f:
        cfg = json.load(f)
    (root / "benchmark" / "configs" / "bdm-blending-fp32.json").write_text(
        json.dumps(dict(cfg, precision="no")))
    (root / "benchmark" / "traffic" / "ddpm1000-b1.json").write_text(
        json.dumps({"kind": "sample", "batch": 1, "points": 4096,
                    "image_size": 224, "camera": {"distance": 1.5,
                                                  "focal_length": 2.1875},
                    "num_inference_steps": 1000, "roll_step": 16,
                    "slices": [[1000, 968, 936, 872, 856]]}))
    (root / "benchmark" / "metrics" / "slices.py").write_text(
        "def read(o):\n    return o.notes.get('slices')\n")
    new = json.loads(json.dumps(m))
    new["configs"].append({"name": "bdm-blending-fp32", "source": "x",
                           "file": "benchmark/configs/bdm-blending-fp32.json",
                           "reduced": [], "why": "x"})
    new["workloads"].append({"name": "throwaway", "config":
                             "bdm-blending-fp32", "traffic": "ddpm1000-b1",
                             "chips": 1, "why": "x"})
    new["per_layer"].append({"name": "slices.sample", "unit": "slices",
                             "better": "higher", "source": "host_clock",
                             "layer": "x", "moves": "sample_step_ms",
                             "workloads": ["throwaway"]})
    for x in new["end_to_end"]:
        if x["name"] == "sample_step_ms":
            x["workloads"].append("throwaway")
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = manifest.load("throwaway", root)
    assert cell.config["precision"] == "no"
    assert cell.traffic["batch"] == 1
    assert {x["name"] for x in cell.end_to_end()} == {"sample_step_ms",
                                                      "setup_s"}
    assert set(cell.readers()) == {"slices.sample"}
    assert cell.driver().__file__.startswith(str(root))
    for p, data in before.items():
        assert p.read_bytes() == data
