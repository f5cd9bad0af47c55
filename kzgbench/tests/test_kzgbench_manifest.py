"""BENCHMARK.json, the configurations, the mixes and the cells parse and
keep to the benchmark's contract: names and units of the allowed
characters, every cell a file of its own that agrees with the manifest,
every metric a reader, every cell reporting set-up, another end-to-end
metric and a per-layer one, and a check of 24 cells that fits its time."""

import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\t\n]{1,200}")


@pytest.fixture(scope="module")
def manifest():
    path = os.path.join(REPO, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as fh:
        return json.load(fh)


def load(*parts):
    with open(os.path.join(BENCH, *parts)) as fh:
        return json.load(fh)


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["kzgbench"]
    assert 1 <= len(manifest["command"]) <= 32 and all(LINE.fullmatch(w) for w in manifest["command"])
    assert os.path.exists(os.path.join(REPO, manifest["command"][1]))
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells: 2 + 14 x 24 runs of rs + 60 s, 2 x 90 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(manifest):
    names = []
    for entry in manifest["configs"] + manifest["workloads"] + manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.fullmatch(entry["name"]), entry["name"]
        names.append(entry["name"])
        for key in ("why", "layer", "source"):
            if key in entry:
                assert LINE.fullmatch(entry[key]), entry[key]
        if "unit" in entry:
            assert UNIT.fullmatch(entry["unit"]) and entry["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        kind_names = [e["name"] for e in manifest[kind]]
        assert len(set(kind_names)) == len(kind_names)
    metrics = [e["name"] for e in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_configs(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("kzgbench/configs/") and c["reduced"] == []
        cfg = load("configs", os.path.basename(c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["BYTES_PER_BLOB"] == 32 * cfg["FIELD_ELEMENTS_PER_BLOB"] == 131072
        assert os.path.exists(os.path.join(BENCH, cfg["trusted_setup"]))
        assert any(w["config"] == c["name"] for w in manifest["workloads"])


def test_cells_are_files_that_agree_with_the_manifest(manifest):
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert load("workloads", f"{w['name']}.json") == {"config": w["config"], "traffic": w["traffic"], "chips": w["chips"]}
        load("traffic", f"{w['traffic']}.json")
    assert len({(w["config"], w["traffic"]) for w in manifest["workloads"]}) == len(manifest["workloads"])


def test_every_metric_has_a_reader_and_every_cell_reports_enough(manifest):
    cells = {w["name"]: load("traffic", f"{w['traffic']}.json")["end_to_end"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        if m["name"] != "setup_s":
            assert os.path.exists(os.path.join(BENCH, "end_to_end", f"{m['name']}.py"))
            assert set(m["workloads"]) == {c for c, names in cells.items() if m["name"] in names}
    for m in manifest["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{m['name']}.py"))
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and all(m["moves"] in cells[c] for c in m["workloads"])
    for cell, names in cells.items():
        assert names and all(n in e2e for n in names)
        assert any(cell in m["workloads"] for m in manifest["per_layer"])


def test_a_metric_reader_names_its_unit(manifest):
    from kzgbench import harness

    readers = {**harness.readers("end_to_end"), **harness.readers("metrics")}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] != "setup_s":
            assert readers[m["name"]].UNIT == m["unit"]
