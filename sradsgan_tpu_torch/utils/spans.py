"""Named spans over the host's phases of a train step and of a request.

``with span("train.vgg"): ...`` marks a phase where the work is handed to
the device.  A span does something in two cases:

- inside :func:`recording`, on the thread that opened it, it records a
  :class:`Span` (its parent, the outermost span it sits in, and its start
  and end on ``time.perf_counter_ns``) into a bounded in-memory ring, which
  the block hands over when it ends; nothing is written on the way;
- while ``torch.profiler`` runs, it enters ``record_function(name)``, so
  that the profiler stamps it as a ``user_annotation`` on the clock of the
  device's kernels and every idle gap of the device trace falls under a
  named phase.

Otherwise a span costs a module-level check and the profiler's own
enabled flag, and returns a shared no-op context.

The spans of the port (name: where; inside):

- ``train.step``: ``Trainer._local_step``; the root of a step
- ``train.capture``: the step's capture into a CUDA graph, the inner
  phases below inside it; in the step (the second step of a graph's key)
- ``train.replay``: the copies of the images and the penalty's weights into
  the graph's static tensors, and its replay; in the step (every graphed
  step after the first)
- ``train.g_forward``: G, pixel loss, content term, D on SR; in the step
- ``train.vgg``: VGG19 on SR and HR and the content loss; in g_forward
- ``train.g_backward``: ``torch.autograd.grad`` of the G's loss; in the step
- ``train.g_optim``: the G's gradient all-reduce and Adam; in the step
- ``train.d_forward``: two D forwards, the penalty's draw and the loss; in
  the step
- ``train.penalty``: the gradient penalty, its grad of grad; in d_forward
- ``train.d_backward``: ``torch.autograd.grad`` of the D's objective; in the
  step
- ``train.d_optim``: the D's all-reduce, Adam and weight clip; in the step
The inner phases, ``train.g_forward`` to ``train.d_optim``, open only on a
step that runs eagerly or is captured (inside ``train.capture`` there): a
replayed step launches nothing of its own, so its phases are not spanned,
and a reader of per-phase host time (``port_bench/spans_segment.py``) sees
them only on those steps.

- ``serve.request``: ``Predictor.__call__``; the root of a request
- ``serve.pad``: the reflect pad up to the bucket; in the request
- ``serve.forward``: staging to the device and the generator's launches
  (``evaluation/tiled.py:_forward``); in the request
- ``serve.fetch``: the copy back to a host array, which waits for the
  device; in the request
- ``serve.crop``: the crop back to the asked size; in the request

- ``hat.window_attention``: a HAB's window attention, its bias gather and
  the attention (``models/hat.py`` ``WindowAttention``; ``qkv`` and
  ``proj`` outside); in the step's or the request's forward
- ``hat.overlap_attention``: an OCAB's overlapping key and value windows,
  its bias gather and the attention (``models/hat.py`` ``OCAB``); in the
  forward
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Deque, Iterator, List, NamedTuple

import torch

RING = 65536  # the records a recording keeps: its last RING spans

_NOOP = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """One closed span: ``index`` counts the spans of a recording in the
    order they opened, ``parent`` is the index of the span it opened in (-1
    at the root), ``root`` the index of the outermost span it sits in, so
    that the spans of one step or one request share it."""

    index: int
    name: str
    parent: int
    root: int
    start_ns: int
    end_ns: int

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class _Recording:
    __slots__ = ("ring", "stack", "count")

    def __init__(self, limit: int):
        self.ring: Deque[Span] = deque(maxlen=limit)
        self.stack: List[_Open] = []
        self.count = 0


_local = threading.local()  # .rec: the calling thread's open recording
_open = 0  # recordings open on any thread, so that off reads one global
_open_lock = threading.Lock()


class _Open:
    """A span recorded on the recording's thread."""

    __slots__ = ("rec", "name", "index", "parent", "root", "start",
                 "annotation")

    def __init__(self, rec: _Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> "_Open":
        rec = self.rec
        self.index = rec.count
        rec.count += 1
        if rec.stack:
            top = rec.stack[-1]
            self.parent, self.root = top.index, top.root
        else:
            self.parent, self.root = -1, self.index
        rec.stack.append(self)
        self.annotation = None
        if _profiling():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.rec.stack.pop()
        self.rec.ring.append(Span(self.index, self.name, self.parent,
                                  self.root, self.start, end))


def span(name: str):
    """A context that marks the phase ``name`` (see the module's
    docstring)."""
    if _open:
        rec = getattr(_local, "rec", None)
        if rec is not None:
            return _Open(rec, name)
    if _profiling():
        return torch.profiler.record_function(name)
    return _NOOP


@contextlib.contextmanager
def recording(limit: int = RING) -> Iterator[List[Span]]:
    """Record the spans the calling thread opens in the block; the yielded
    list receives the last ``limit`` of them, in the order they opened,
    when the block ends.  A recording inside another takes the spans of
    its own block; recordings on other threads are apart from it."""
    global _open
    outer = getattr(_local, "rec", None)
    rec = _local.rec = _Recording(limit)
    with _open_lock:
        _open += 1
    records: List[Span] = []
    try:
        yield records
    finally:
        _local.rec = outer
        with _open_lock:
            _open -= 1
        records.extend(sorted(rec.ring))

