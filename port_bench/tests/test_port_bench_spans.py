"""The program's phase spans: what ``breakdown`` names an idle gap after,
and the spans segment's sums of a recording, on the CPU."""

import json

import pytest

from port_bench import spans_segment, trace
from port_bench.tests.dropin import TRAIN_CELL, add_edsr
from port_bench.tests.tiny import tiny_copy
from sradsgan_tpu_torch.utils.spans import Span


PHASES = {"train": {"train.step", "train.g_forward", "train.vgg",
                    "train.g_backward", "train.g_optim", "train.d_forward",
                    "train.penalty", "train.d_backward", "train.d_optim"},
          "serve": {"serve.request", "serve.pad", "serve.forward",
                    "serve.fetch", "serve.crop"},
          "pixel": {"train.step", "train.g_forward", "train.g_backward",
                    "train.g_optim"}}


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1 if cat in trace.HOST_CATEGORIES else 0, "tid": tid,
            "args": {}}


def note(name, ts, dur, tid=1):
    return ev("user_annotation", name, ts, dur, tid)


def train_trace(spans=True):
    """Two steps of 100 us under ``bench.step``; the device runs only in
    the G's forward, so the backward's wait is idle."""
    events = [note(trace.WINDOW_SPAN, 0, 200)]
    for t0 in (0, 100):
        events += [note("bench.step", t0, 100),
                   ev("kernel", "conv", t0 + 5, 10, tid=7)]
        if spans:
            events += [note("train.step", t0 + 1, 98),
                       note("train.g_forward", t0 + 2, 20),
                       note("train.vgg", t0 + 5, 10),
                       note("train.g_backward", t0 + 22, 40),
                       note("train.g_optim", t0 + 62, 6),
                       note("train.d_forward", t0 + 68, 14),
                       note("train.penalty", t0 + 70, 8),
                       note("train.d_backward", t0 + 82, 10),
                       note("train.d_optim", t0 + 94, 4)]
    return trace.from_events(events)


def test_an_idle_gap_in_the_step_falls_in_its_phase():
    gaps = dict(trace.breakdown(train_trace())["idle_gaps"])
    # the device idles over [0, 5), [15, 105) and [115, 200): the first
    # gap's middle lies in the G's forward, the others' (60, 157.5) in the
    # G's backward, nested in bench.step
    assert gaps == {"train.g_forward": pytest.approx(5e-6),
                    "train.g_backward": pytest.approx(175e-6)}
    without = dict(trace.breakdown(train_trace(spans=False))["idle_gaps"])
    assert without == {"bench.step": pytest.approx(180e-6)}


def test_a_recording_sums_by_unit():
    ms = 1_000_000
    records = [Span(0, "serve.request", -1, 0, 0, 10 * ms),
               Span(1, "serve.pad", 0, 0, 1 * ms, 2 * ms),
               Span(2, "serve.forward", 0, 0, 2 * ms, 6 * ms),
               Span(3, "serve.request", -1, 3, 20 * ms, 25 * ms),
               Span(4, "serve.forward", 3, 3, 20 * ms, 23 * ms),
               Span(5, "serve.forward", 3, 3, 23 * ms, 24 * ms)]
    assert spans_segment.per_unit_ms(records) == [
        {"serve.request": 10.0, "serve.pad": 1.0, "serve.forward": 4.0},
        {"serve.request": 5.0, "serve.forward": 4.0}]
    assert spans_segment.root_self_ms(records) == [5.0, 1.0]
    # two recordings, whose indices both start at 0, stay apart
    assert spans_segment.by_name([records, records[:3]])[
        "serve.request"] == [10.0, 5.0, 10.0]


@pytest.mark.parametrize("cell,phases", [
    ("sradsgan_x4.train_b16", "train"), ("sradsgan_x4.serve_ucm", "serve"),
    (TRAIN_CELL, "pixel")])
def test_the_spans_segment_runs_a_cell(tmp_path, cell, phases, capsys):
    manifest = tiny_copy(tmp_path)
    add_edsr(manifest)  # a pixel-only step: the G's phases alone
    assert spans_segment.main(
        ["--workload", cell, "--seed", "2147483659", "--rounds", "2",
         "--per", "2", "--device", "cpu", "--manifest", str(manifest),
         "--out", str(tmp_path / "out")]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["host_ms"]) == PHASES[phases]
    assert line["wall_ms"]["off"]["n"] == line["wall_ms"]["recorded"]["n"] == 4
    assert set(line["host_ms_profiled"]) == set(line["host_ms"])
    assert (tmp_path / "out" / f"{cell}.2147483659.json").exists()
