"""The HAT x4 configuration (``configs/hat_x4.json``, its plain reference
``reference/hat_x4.py``) in the tiny copy on the CPU, and the readers of
its attention (``attention.py``, ``metrics/attention_*.serve.py``)."""

import json
from pathlib import Path

import pytest

from port_bench import attention, harness, roofline, serve, train, trace
from port_bench.tests.tiny import float32_copy, run_cell

TRAIN_CELL, SERVE_CELL = "hat_x4.train_b4", "hat_x4.serve_ucm"
SEED = 2_147_483_659
REPO = Path(__file__).resolve().parents[2]
CONFIG = json.loads((REPO / "port_bench" / "configs" / "hat_x4.json")
                    .read_text())
CONFIG["reference"] = str(REPO / "port_bench" / CONFIG["reference"])


@pytest.fixture
def manifest(tmp_path):
    return float32_copy(tmp_path)


@pytest.mark.parametrize("cell,metrics", [
    (TRAIN_CELL, ({"train_mpix_s", "setup_s"},
                  {"feed_wait.train", "mfu.train", "device_idle.train"})),
    (SERVE_CELL, ({"serve_mpix_s", "request_p95_ms", "setup_s"},
                  {"device_idle.serve"}))])
def test_both_cells_run_correct_traced_and_not(manifest, cell, metrics):
    """The attention readers read nothing on the CPU, which has no device
    operations to link to the spans."""
    for traced in (0, 1):
        rc, line, err = run_cell(manifest, cell, trace=traced)
        assert rc == 0, err[-3000:]
        assert line["correct"] is True, line
        assert set(line["metrics"]) == metrics[traced], line["metrics"]


@pytest.mark.parametrize("cell,fault", [(TRAIN_CELL, "half_batch"),
                                        (SERVE_CELL, "altered_answer")])
def test_a_planted_fault_fails_the_check(manifest, cell, fault):
    rc, line, err = run_cell(manifest, cell, plant=fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line


@pytest.mark.parametrize("cell", [TRAIN_CELL, SERVE_CELL])
def test_unshifted_windows_fail_the_check(manifest, cell, monkeypatch,
                                          tmp_path):
    """``no_shift``: every HAB of the program attends over unshifted
    windows (roll and mask dropped); the check sees the mechanism, not only
    the batch and the sign."""
    from sradsgan_tpu_torch.models import hat

    init = hat.HAB.__init__

    def unshifted(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.shift = 0
    monkeypatch.setattr(hat.HAB, "__init__", unshifted)
    c = harness.load_cell(cell, manifest)
    run = train.run if c.traffic["kind"] == "train" else serve.run
    measured = run(c, SEED, 0.2, False, "cpu", str(tmp_path))
    assert not harness.passed(harness.check(measured["readings"], c.limits))


def _event(cat, name, ts, dur, **args):
    return {"cat": cat, "name": name, "ph": "X", "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def synthetic_trace() -> trace.Trace:
    """A window of 1000 us: a window attention span over [100, 200], an
    overlap attention span over [300, 350]; five device operations of 40,
    60, 20, 30 and 50 us, the first and third launched inside a span, and
    a copy launched inside one through the driver's API."""
    events = [_event("user_annotation", trace.WINDOW_SPAN, 0, 1000),
              _event("user_annotation", "hat.window_attention", 100, 100),
              _event("user_annotation", "hat.overlap_attention", 300, 50),
              _event("user_annotation", "serve.forward", 50, 500)]
    launches = [("cuda_runtime", 150, 1), ("cuda_runtime", 250, 2),
                ("cuda_runtime", 320, 3), ("cuda_runtime", 400, 4),
                ("cuda_driver", 199, 5)]
    events += [_event(cat, "cudaLaunchKernel", ts, 5, correlation=c)
               for cat, ts, c in launches]
    for c, (start, dur, cat) in enumerate(
            [(160, 40, "kernel"), (260, 60, "kernel"), (330, 20, "kernel"),
             (410, 30, "kernel"), (500, 50, "gpu_memcpy")], start=1):
        events.append({"cat": cat, "name": f"k{c}", "ph": "X", "ts": start,
                       "dur": dur, "pid": 0, "tid": 7,
                       "args": {"correlation": c}})
    return trace.from_events(events)


def _reader(name):
    return harness.metric_reader(name, REPO / "port_bench")


def test_the_share_reader_links_kernels_to_the_spans():
    tr = synthetic_trace()
    assert attention.device_s(tr) == pytest.approx((110e-6, 200e-6))
    share = _reader("attention_share.serve")({"trace": tr})
    assert share == pytest.approx(100.0 * 110 / 200)
    bare = trace.from_events([e for e in tr.events
                              if not e["name"].startswith("hat.")])
    assert _reader("attention_share.serve")({"trace": bare}) is None


class _Cell:
    config = CONFIG
    traffic = {"buckets": [54, 72, 108, 216]}


def test_the_roofline_reader_reads_the_bound_over_the_spans(monkeypatch):
    """Two traced requests of 8 x 54^2 (the model pads them to 64^2): the
    bound of their 84 calls over the 110 us under the spans; the counters
    checked over every request of the run (two warm-ups, one in the
    window, the two traced)."""
    from sradsgan_tpu_torch.models import hat

    per = attention.calls(CONFIG, 8, 54)
    logits = sum(c.logits for c in per)
    monkeypatch.setattr(hat._attend, "calls", 5 * len(per))
    monkeypatch.setattr(hat._attend, "logit_elements", 5 * logits)
    measured = {"traced_shapes": [(8, 54), (8, 54)],
                "request_shapes": [(8, 54, 54)]}
    ctx = {"trace": synthetic_trace(), "measured": measured,
           "cell": _Cell(), "card": {"max_sm_mhz": "1980"}}
    want = 2 * attention.bound_s(per, "float32", 1980) / 110e-6
    got = _reader("attention_roofline.serve")(ctx)
    assert got == pytest.approx(100.0 * want)
    monkeypatch.setattr(hat._attend, "calls", 5 * len(per) - 1)
    assert _reader("attention_roofline.serve")(ctx) is None


def test_the_calls_at_published_widths_are_the_closed_form():
    """A request of 8 images of 64^2: 36 window attentions over 16^2
    windows (the mask on the odd ones) and 6 overlap attentions over 24^2
    keys, 6 heads of 30; each call's bytes, FLOPs and exponentials."""
    calls = attention.calls(CONFIG, 8, 64)
    assert len(calls) == 42
    windows, heads, d = 8 * 4 * 4, 6, 30
    for i, c in enumerate(calls):
        overlap = i % 7 == 6
        nk = 24 * 24 if overlap else 16 * 16
        table = (16 + 24 - 1) ** 2 if overlap else (2 * 16 - 1) ** 2
        assert c == attention.Call(windows, heads, 256, nk, d, heads * table)
        n = c.counts(4)
        assert n["exps"] == windows * heads * 256 * nk
        assert n["flops"] == 2 * 2 * windows * heads * 256 * nk * d
        assert n["bytes"] == (4 * windows * heads * d * (2 * 256 + 2 * nk)
                              + 4 * heads * table)
    bound = attention.bound_s(calls, "float32", 1980)
    # bytes-bound: each call's bytes over the memory rate
    assert bound == pytest.approx(sum(
        c.counts(4)["bytes"] for c in calls) / roofline.PEAK_BYTES_PER_S)
