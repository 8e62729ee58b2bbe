"""The span facility (``utils/spans.py``) and the spans of the train step
and of a request, on the CPU at tiny widths."""

import re
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from sradsgan_tpu_torch import models  # noqa: E402
from sradsgan_tpu_torch.serving import Predictor  # noqa: E402
from sradsgan_tpu_torch.train.trainer import Trainer  # noqa: E402
from sradsgan_tpu_torch.utils import spans  # noqa: E402
from sradsgan_tpu_torch.utils.spans import recording, span  # noqa: E402

TRAIN_SPANS = ["train.step", "train.g_forward", "train.vgg",
               "train.g_backward", "train.g_optim", "train.d_forward",
               "train.penalty", "train.d_backward", "train.d_optim"]
# a graphed step's (tests/test_torch_trainer_graph.py records them on a card)
GRAPH_SPANS = ["train.capture", "train.replay"]
SERVE_SPANS = ["serve.request", "serve.pad", "serve.forward", "serve.fetch",
               "serve.crop"]


def _no_record_function(name):
    raise AssertionError(f"record_function({name!r}) entered")


def test_off_records_nothing_and_enters_no_annotation(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function",
                        _no_record_function)
    with span("train.step"):
        with span("train.vgg"):
            pass
    assert span("train.step") is spans._NOOP
    # a recording takes only its own thread's spans
    with recording() as records:
        worker = threading.Thread(target=lambda: span("other").__enter__())
        worker.start()
        worker.join(timeout=10)
    assert not worker.is_alive()
    assert records == []


def test_recordings_on_two_threads_are_apart():
    opened, go_on = threading.Event(), threading.Event()
    theirs = []

    def other():
        with recording() as records:
            with span("b.0"):
                pass
            opened.set()
            go_on.wait(10)
            with span("b.1"):
                pass
        theirs.extend(records)

    with recording() as records:
        with span("a.0"):
            pass
        worker = threading.Thread(target=other)
        worker.start()
        assert opened.wait(10)
        with span("a.1"):  # while the other thread records
            pass
        go_on.set()
        worker.join(timeout=10)
        with span("a.2"):  # after its recording ended
            pass
    assert not worker.is_alive()
    assert [s.name for s in records] == ["a.0", "a.1", "a.2"]
    assert [s.name for s in theirs] == ["b.0", "b.1"]
    assert span("a.3") is spans._NOOP


def test_nesting_gives_parents_and_roots():
    with recording() as records:
        for _ in range(2):
            with span("train.step"):
                with span("train.g_forward"):
                    with span("train.vgg"):
                        pass
                with span("train.g_backward"):
                    pass
    got = [(s.index, s.name, s.parent, s.root) for s in records]
    assert got == [(0, "train.step", -1, 0), (1, "train.g_forward", 0, 0),
                   (2, "train.vgg", 1, 0), (3, "train.g_backward", 0, 0),
                   (4, "train.step", -1, 4), (5, "train.g_forward", 4, 4),
                   (6, "train.vgg", 5, 4), (7, "train.g_backward", 4, 4)]
    for s in records:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = records[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # the recording ended: spans are off again
    assert span("train.step") is spans._NOOP


def test_the_ring_keeps_its_bound():
    with recording(limit=4) as records:
        for i in range(10):
            with span(f"s{i}"):
                pass
    assert [s.name for s in records] == ["s6", "s7", "s8", "s9"]
    assert [s.index for s in records] == [6, 7, 8, 9]


@pytest.mark.parametrize("recorded", [False, True])
def test_a_span_is_an_annotation_under_the_profiler(recorded):
    x = torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if recorded:
            with recording() as records:
                with span("serve.forward"):
                    torch.add(x, 1)
        else:
            with span("serve.forward"):
                torch.add(x, 1)
    events = [e for e in prof.events() if e.name in ("serve.forward",
                                                     "aten::add")]
    (ann,) = [e for e in events if e.name == "serve.forward"]
    (op,) = [e for e in events if e.name == "aten::add"]
    assert (ann.time_range.start <= op.time_range.start
            and op.time_range.end <= ann.time_range.end)
    if recorded:
        assert [s.name for s in records] == ["serve.forward"]


def test_a_train_step_records_its_nine_spans(tmp_path):
    cfg = models.config_for_model("sradsgan", 2, bf16=False,
                                  save_dir=str(tmp_path))
    cfg.model_kwargs = dict(base_filters=16, n_groups=1, n_blocks=1)
    trainer = Trainer(cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"lr": rng.random((2, 8, 8, 3), dtype=np.float32),
             "hr": rng.random((2, 16, 16, 3), dtype=np.float32)}
    with recording() as records:
        trainer.train_step(batch)
    assert [s.name for s in records] == TRAIN_SPANS
    assert {s.root for s in records} == {0}
    parent = {s.name: records[s.parent].name for s in records[1:]}
    assert parent == {"train.g_forward": "train.step",
                      "train.vgg": "train.g_forward",
                      "train.g_backward": "train.step",
                      "train.g_optim": "train.step",
                      "train.d_forward": "train.step",
                      "train.penalty": "train.d_forward",
                      "train.d_backward": "train.step",
                      "train.d_optim": "train.step"}
    # the clip ran inside the D's optimizer span
    clip = cfg.gan.clip_value
    assert all(float(p.detach().abs().max()) <= clip
               for p in trainer.discriminator.parameters())


def test_a_request_records_its_phases():
    g = models.create_generator("sradsgan", 2, base_filters=16, n_groups=1,
                                n_blocks=1)
    predictor = Predictor(g, 2, buckets=(8,), device="cpu")
    lr = np.random.default_rng(0).random((2, 6, 7, 3), dtype=np.float32)
    with recording() as records:
        out = predictor(lr)
    assert out.shape == (2, 12, 14, 3)
    assert [s.name for s in records] == SERVE_SPANS
    assert [s.parent for s in records] == [-1, 0, 0, 0, 0]
    request = records[0]
    assert sum(s.ns for s in records[1:]) <= request.ns


def test_every_span_of_the_port_is_listed_and_documented():
    """The span names in the port's modules (``"train.*"`` and
    ``"serve.*"`` literals outside ``utils/spans.py``) are this file's
    lists, and each is in ``utils/spans.py``'s table of spans."""
    root = Path(spans.__file__).resolve().parent.parent
    opened = set()
    for path in root.rglob("*.py"):
        if path.name != "spans.py":
            opened |= set(re.findall(r'"((?:train|serve)\.[a-z_]+)"',
                                     path.read_text()))
    assert opened == set(TRAIN_SPANS + GRAPH_SPANS + SERVE_SPANS)
    for name in opened:
        assert f"``{name}``" in spans.__doc__, name
