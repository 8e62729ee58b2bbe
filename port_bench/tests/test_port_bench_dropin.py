"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell by adding files and manifest entries alone: the harness finds
each by its name, and no file that was there changes."""

import hashlib
import json

from port_bench.tests.tiny import float32_copy, run_cell

NEW_METRIC = '''"""Steps the untraced window took."""


def read(ctx):
    return float(ctx["measured"]["steps"])
'''


def digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_new_files_and_entries_are_found(tmp_path):
    manifest = float32_copy(tmp_path)
    bench = tmp_path / "port_bench"
    before = digests(bench)

    config = json.loads((bench / "configs" / "sradsgan_x4.json").read_text())
    config["name"] = "sradsgan_x4_wide"
    config["widths"] = {"base_filters": 24, "n_groups": 1, "n_blocks": 2}
    (bench / "configs" / "sradsgan_x4_wide.json").write_text(
        json.dumps(config))
    mix = json.loads((bench / "traffic" / "train_b16.json").read_text())
    mix.update(batch=2, lr_size=6)
    (bench / "traffic" / "train_b2.json").write_text(json.dumps(mix))
    (bench / "metrics" / "steps_seen.train.py").write_text(NEW_METRIC)
    cell = "sradsgan_x4_wide.train_b2"
    (bench / "limits" / f"{cell}.json").write_text(
        (bench / "limits" / "sradsgan_x4.train_b16.json").read_text())

    m = json.loads(manifest.read_text())
    m["configs"].append({"name": "sradsgan_x4_wide", "source": "test",
                         "file": "port_bench/configs/sradsgan_x4_wide.json",
                         "reduced": [], "why": "a drop-in"})
    m["workloads"].append({"name": cell, "config": "sradsgan_x4_wide",
                           "traffic": "train_b2", "chips": 1,
                           "why": "a drop-in"})
    for e in m["end_to_end"]:
        if e["name"] == "train_mpix_s":
            e["workloads"].append(cell)
    m["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "train step", "moves": "train_mpix_s",
                           "workloads": [cell]})
    manifest.write_text(json.dumps(m))

    rc, line, err = run_cell(manifest, cell, trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True
    assert line["metrics"]["steps_seen.train"]["value"] >= 1
    rc, line, err = run_cell(manifest, cell, trace=0)
    assert rc == 0 and set(line["metrics"]) == {"train_mpix_s", "setup_s"}
    after = digests(bench)
    assert {p: d for p, d in after.items() if p in before} == before
