"""BENCHMARK.json against the benchmark's contract: names, units, keys,
metric wiring, and the files the harness finds by name."""

import os
import re

import pytest

from lbmbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in MAN["end_to_end"]}


def all_metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"][0] == "python3" and len(MAN["command"]) <= 32
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")


@pytest.mark.parametrize("m", all_metrics(), ids=lambda m: m["name"])
def test_metric_names_and_units(m):
    assert NAME.match(m["name"])
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if m in MAN["end_to_end"]:
        allowed |= {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert set(m) <= allowed


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cells(w):
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in harness.metrics_of(MAN, w["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(MAN, w["name"], "per_layer")
    found = harness.find_cell(w["name"], MAN)
    assert os.path.exists(os.path.join(harness.HERE, "drivers",
                                       found["config"]["driver"] + ".py"))


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_moves_names_a_metric_its_cells_report(m):
    assert m["moves"] in E2E
    cells = m.get("workloads", [w["name"] for w in MAN["workloads"]])
    for cell in cells:
        reported = {x["name"] for x in harness.metrics_of(MAN, cell, "end_to_end")}
        assert m["moves"] in reported, (m["name"], cell)
    assert os.path.exists(os.path.join(harness.HERE, "metrics", m["name"] + ".py"))


def test_layers_spelled_alike_for_one_layer():
    by_prefix = {}
    for m in MAN["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values()), by_prefix


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    assert len(c["reduced"]) <= 16 and 1 <= len(c["source"]) <= 200
    assert c["file"].startswith(MAN["paths"][0] + "/")
    body = harness.load_json(os.path.join(harness.ROOT, c["file"]))
    assert body["reduced"] == c["reduced"] and "assumed" in body and "limits" in body
    assert any(w["config"] == c["name"] for w in MAN["workloads"])


def test_unique_names_and_pairs():
    names = [x["name"] for x in all_metrics()]
    assert len(names) == len(set(names))
    cells = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(cells) == len(set(cells))
    assert len({w["name"] for w in MAN["workloads"]}) == len(MAN["workloads"])


def test_check_budget_fits_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_new_cell_is_found_by_name(tmp_path):
    """A cell added as files alone: its entry in BENCHMARK.json and its
    traffic file under workloads/, nothing else edited."""
    import json
    import shutil

    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "lbmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads(json.dumps(MAN))
    man["workloads"].append({"name": "urban5.tiny", "config": "urban_2432x1152_lockstep5",
                             "traffic": "dataset_tiny", "chips": 1, "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    (root / "lbmbench" / "workloads" / "urban5.tiny.json").write_text(json.dumps(
        {"traffic": "dataset_tiny", "record": True, "sample_groups": 1, "trace_chunks": [3, 6]}))
    found = harness.find_cell("urban5.tiny", harness.manifest(str(root)), root=str(root))
    assert found["workload"]["traffic"] == "dataset_tiny"
    assert found["config"]["driver"] == "lockstep_dataset"
    with pytest.raises(harness.Refused):
        harness.find_cell("urban5.absent", man, root=str(root))
