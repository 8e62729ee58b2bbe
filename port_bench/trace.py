"""The traced segment of a run and the arithmetic on its trace.

A segment runs under ``torch.profiler`` (CPU and CUDA activities, the
input shapes recorded) inside the span ``bench.traced``; its Chrome trace
is written to a temporary file, read back and deleted.  Device time is the
union of the intervals of kernels, copies and sets on every stream (the
feed's copy stream and NCCL's run beside the compute stream), never their
sum.  The program's own kernels are found in it by name, the names of the
kernels its library is built from, with or without a host op call around
their launch: a CUDA graph's replay makes none.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import json
import os
import re
import sys
import tempfile
from collections import defaultdict
from typing import (Callable, Dict, FrozenSet, Iterable, List, Optional,
                    Tuple)

import torch

WINDOW_SPAN = "bench.traced"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")

Interval = Tuple[float, float]


@dataclasses.dataclass
class Trace:
    """The events of a traced segment (Chrome trace dicts, times in us)
    and its window."""

    events: List[Dict]
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def device(self) -> List[Dict]:
        return [e for e in self.events
                if e.get("cat") in DEVICE_CATEGORIES and e.get("ph") == "X"]

    def host(self) -> List[Dict]:
        return [e for e in self.events
                if e.get("cat") in HOST_CATEGORIES and e.get("ph") == "X"]


def from_events(events: List[Dict]) -> Trace:
    """A Trace whose window is the ``bench.traced`` span's."""
    span = next(e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == WINDOW_SPAN)
    return Trace(events, span["ts"], span["ts"] + span["dur"])


def run_traced(fn: Callable[[], None], directory: Optional[str] = None
               ) -> Trace:
    """Run ``fn`` (which ends by waiting for the device) under the
    profiler and return its trace (its summary on standard error)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True) as prof:
        with record_function(WINDOW_SPAN):
            fn()
    fd, path = tempfile.mkstemp(suffix=".json", dir=directory)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    trace = from_events(events)
    print(f"trace {json.dumps(summary(trace))}", file=sys.stderr)
    return trace


def interval(e: Dict) -> Interval:
    return (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))


def union(intervals: Iterable[Interval], lo: float, hi: float
          ) -> List[Interval]:
    """The union of the intervals clipped to [lo, hi], as sorted disjoint
    intervals."""
    merged: List[Interval] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def busy_s(trace: Trace, names: Optional[Callable[[str], bool]] = None
           ) -> float:
    """Seconds of the window in which some device operation (whose name
    ``names`` accepts) runs on some stream."""
    events = [e for e in trace.device()
              if names is None or names(e.get("name", ""))]
    return sum(b - a for a, b in union(map(interval, events), trace.start,
                                       trace.end)) / 1e6


def summary(trace: Trace) -> Dict[str, float]:
    """For the look: device events, their summed and their union seconds,
    and the summed seconds by stream."""
    events = trace.device()
    streams: Dict[str, float] = defaultdict(float)
    for e in events:
        a, b = interval(e)
        streams[str(e.get("tid"))] += max(0.0, min(b, trace.end)
                                          - max(a, trace.start)) / 1e6
    return {"events": len(events), "sum_s": sum(streams.values()),
            "union_s": busy_s(trace), "window_s": trace.window_s,
            "by_stream_s": dict(streams)}


def idle_gaps(trace: Trace) -> List[Interval]:
    """The parts of the window in which no device operation runs."""
    busy = union(map(interval, trace.device()), trace.start, trace.end)
    gaps, t = [], trace.start
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if trace.end > t:
        gaps.append((t, trace.end))
    return gaps


def _top(totals: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:n]]


def breakdown(trace: Trace) -> Dict[str, List[List]]:
    """The device operations that took most time (seconds, by name) and
    the idle gaps' seconds by what the host's main thread was doing: the
    innermost host span that covers a gap's middle."""
    ops: Dict[str, float] = defaultdict(float)
    for e in trace.device():
        a, b = interval(e)
        ops[e.get("name", "?")] += max(0.0, min(b, trace.end)
                                       - max(a, trace.start)) / 1e6
    span = next(e for e in trace.host() if e.get("name") == WINDOW_SPAN)
    main = [e for e in trace.host()
            if e.get("tid") == span.get("tid") and e.get("pid")
            == span.get("pid")]
    main.sort(key=lambda e: float(e["ts"]))
    starts = [float(e["ts"]) for e in main]
    gaps: Dict[str, float] = defaultdict(float)
    for a, b in idle_gaps(trace):
        mid = (a + b) / 2
        # spans nest: the latest-starting span that covers mid is innermost
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and interval(main[i])[1] < mid:
            i -= 1
        gaps[main[i].get("name", "?") if i >= 0 else "host"] += (b - a) / 1e6
    return {"device_ops": _top(ops), "idle_gaps": _top(gaps)}


def op_calls(trace: Trace, prefix: str) -> List[Dict]:
    """The host calls of the ops whose names start with ``prefix``, each
    with its input dims and types and the summed device seconds of the
    kernels it launched (linked by the trace's External id)."""
    calls = {}
    for e in trace.host():
        if e.get("cat") == "cpu_op" and e.get("name", "").startswith(prefix):
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                args = e["args"]
                calls[ext] = {"name": e["name"][len(prefix):],
                              "dims": args.get("Input Dims", []),
                              "types": args.get("Input type", []),
                              "concrete": args.get("Concrete Inputs", []),
                              "device_s": 0.0, "kernels": 0}
    for e in trace.device():
        ext = e.get("args", {}).get("External id")
        if ext in calls:
            calls[ext]["device_s"] += float(e.get("dur", 0)) / 1e6
            calls[ext]["kernels"] += 1
    return list(calls.values())


COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


def global_functions(source: str) -> List[str]:
    """The names of the ``__global__`` functions a CUDA source defines or
    declares (comments left out)."""
    text = COMMENT.sub(" ", source)
    names = []
    for m in re.finditer(r"\b__global__\b", text):
        rest = text[m.end():]
        # skip __launch_bounds__(...), whose arguments may nest parentheses
        bounds = rest.find("__launch_bounds__")
        if 0 <= bounds < rest.find("("):
            depth, i = 0, rest.index("(", bounds)
            while True:
                depth += {"(": 1, ")": -1}.get(rest[i], 0)
                i += 1
                if depth == 0:
                    break
            rest = rest[i:]
        names.append(re.match(r"[^(]*?(\w+)\s*\(", rest, re.S).group(1))
    return names


@functools.lru_cache(maxsize=None)
def kernel_names() -> FrozenSet[str]:
    """The names of the program's own kernels: every ``__global__``
    function in the sources its kernel library is built from (all of
    ``sradsgan_tpu_torch/csrc``, headers too), so a kernel added there is
    counted with no change here."""
    from sradsgan_tpu_torch.ops import _build

    return frozenset(name for path in sorted(_build.CSRC_DIR.iterdir())
                     if path.is_file()
                     for name in global_functions(path.read_text()))


def kernel_function(name: str) -> str:
    """A kernel event's function name without its scope, template
    arguments and parameters: ``void (anonymous namespace)::gate_kernel<
    __nv_bfloat16, 0>(...)`` -> ``gate_kernel``."""
    head = re.split(r"[<(]", name.replace("(anonymous namespace)::", ""), 1)
    return head[0].split()[-1].split("::")[-1] if head[0].split() else ""


def kernel_s(trace: Trace) -> float:
    """Summed seconds, inside the window, of the program's own kernels
    (``kernel_names``), on every stream."""
    names = kernel_names()
    total = 0.0
    for e in trace.device():
        if e.get("cat") == "kernel" and kernel_function(
                e.get("name", "")) in names:
            a, b = interval(e)
            total += max(0.0, min(b, trace.end) - max(a, trace.start))
    return total / 1e6
