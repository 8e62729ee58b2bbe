"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell by adding files and manifest entries alone: the harness finds
each by its name, and no file that was there changes.  A configuration of
another model of the program's registry brings its own plain reference and
a pixel-only recipe the same way (``dropin.py``)."""

import hashlib
import json

import pytest

from port_bench import calibrate, harness, train
from port_bench.tests.dropin import (SERVE_CELL, SERVE_METRICS, TRAIN_CELL,
                                     TRAIN_METRICS, add_edsr)
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


def test_a_pixel_only_configuration_of_another_model_drops_in(tmp_path):
    """EDSR with its own reference module and an L1 recipe: both cells run
    correct traced and untraced, and no file that was there changes."""
    manifest = float32_copy(tmp_path)
    bench = tmp_path / "port_bench"
    before = digests(bench)
    train_cell, serve_cell = add_edsr(manifest)
    for cell, e2e, layer in ((train_cell, {"train_mpix_s"}, TRAIN_METRICS),
                             (serve_cell, {"serve_mpix_s", "request_p95_ms"},
                              SERVE_METRICS)):
        for trace in (0, 1):
            rc, line, err = run_cell(manifest, cell, trace=trace)
            assert rc == 0, err[-3000:]
            assert line["correct"] is True, line
            want = set(layer) if trace else e2e | {"setup_s"}
            assert set(line["metrics"]) == want, line["metrics"]
    after = digests(bench)
    assert {p: d for p, d in after.items() if p in before} == before


@pytest.mark.parametrize("cell,fault", [(TRAIN_CELL, "half_batch"),
                                        (TRAIN_CELL, "unchanged"),
                                        (SERVE_CELL, "altered_answer")])
def test_a_fault_fails_the_dropin(tmp_path, cell, fault):
    manifest = float32_copy(tmp_path)
    add_edsr(manifest)
    rc, line, err = run_cell(manifest, cell, plant=fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line


def test_the_control_fails_the_dropin(tmp_path):
    """The reference with float8 operands, in the program's place, fails
    the drop-in's limits through the module's ``Conv``s, and so does the
    reference on half of each batch."""
    manifest = float32_copy(tmp_path)
    add_edsr(manifest)
    c = harness.load_cell(TRAIN_CELL, manifest)
    measured = train.run(c, 2_147_483_659, 0.0, False, "cpu", str(tmp_path))
    assert harness.passed(harness.check(measured["readings"], c.limits))
    assert set(measured["readings"]) == {
        f"{k}{w}" for k in ("grad_gap_g", "change1_gap", "change_gap")
        for w in ("", "_worst")} | {"loss_gap", "loss_gap_first",
                                    "loss_gap_g"}
    upper = calibrate.train_upper(c, measured, "cpu")
    for name in ("control", "half_batch"):
        assert not harness.passed(harness.check(upper[name], c.limits)), (
            name, upper[name])
