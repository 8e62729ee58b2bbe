"""Whole runs on the CPU (the look for cards skipped) at tiny widths in
float32, sound and with a fault planted under the timed path: a sound run
is correct, and each fault a cell can have makes ``correct`` false."""

import pytest

from port_bench.tests.tiny import float32_copy, run_cell

TRAIN = "sradsgan_x4.train_b16"
SERVE = "sradsgan_x4.serve_ucm"


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return float32_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", [TRAIN, SERVE, "sragan_x4.train_b16"])
def test_sound_run_is_correct(manifest, cell):
    rc, line, err = run_cell(manifest, cell)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line
    assert list(line)[-1] == "check"
    assert line["failed"] == 0 and line["attempted"] > 0
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("cell,fault", [(TRAIN, "unchanged"),
                                        (TRAIN, "half_batch"),
                                        (SERVE, "altered_answer")])
def test_fault_makes_correct_false(manifest, cell, fault):
    rc, line, err = run_cell(manifest, cell, plant=fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line


def test_traced_run_reports_per_layer_metrics(manifest):
    rc, line, err = run_cell(manifest, TRAIN, trace=1)
    assert rc == 0, err[-3000:]
    assert {"feed_wait.train", "mfu.train"} <= set(line["metrics"])
    assert "breakdown" in line and line["device"]["window_s"] > 0
