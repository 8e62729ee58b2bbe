"""``BENCHMARK.json`` against the contract's form: keys, names, units,
lengths, and that every file it names, and every file the harness finds by
a name in it, is there."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
TEXT_FIELDS = ("why", "layer", "source")


def names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[key]:
            yield entry["name"]
    for w in MANIFEST["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in MANIFEST["configs"]:
        yield from c["reduced"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert 1 <= len(MANIFEST["paths"]) <= 16
    assert all(PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
               for p in MANIFEST["paths"])
    assert len(MANIFEST["command"]) <= 32
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("name", sorted(set(names())))
def test_names_use_allowed_characters(name):
    assert NAME.fullmatch(name), name


def test_units_and_directions():
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25


def test_text_fields_are_one_short_line():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[key]:
            for field in TEXT_FIELDS:
                if field in entry:
                    text = entry[field]
                    assert 1 <= len(text) <= 200, (entry["name"], field)
                    assert "\n" not in text and "\t" not in text


def test_entries_have_just_their_keys():
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}
    for key, keys in allowed.items():
        for entry in MANIFEST[key]:
            assert set(entry) <= keys, entry["name"]


def test_every_name_is_unique():
    for key in ("configs", "workloads"):
        got = [e["name"] for e in MANIFEST[key]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_cells_report_what_they_must():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MANIFEST["workloads"]) // 4)
    for w in MANIFEST["workloads"]:
        assert w["chips"] in (1, 4)
        reported = {n for n, m in e2e.items()
                    if w["name"] in m.get("workloads", [w["name"]])}
        assert len(reported - {"setup_s"}) >= 1, w["name"]
        layer = [m for m in MANIFEST["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in reported, (w["name"], m["name"])
    configs = {c["name"] for c in MANIFEST["configs"]}
    assert configs == {w["config"] for w in MANIFEST["workloads"]}


def test_named_files_are_there():
    bench = REPO / MANIFEST["paths"][0]
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        path = REPO / c["file"]
        assert path.is_file() and path.is_relative_to(bench)
        cfg = json.loads(path.read_text())
        assert cfg["source"] == c["source"]
        if "reference" in cfg:  # the configuration's own plain reference
            assert (bench / cfg["reference"]).is_file()
    for w in MANIFEST["workloads"]:
        assert (bench / "traffic" / f"{w['traffic']}.json").is_file()
        assert (bench / "limits" / f"{w['name']}.json").is_file()
    for m in MANIFEST["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()
