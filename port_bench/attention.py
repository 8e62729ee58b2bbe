"""HAT's two attentions in a traced segment: the device time of the kernels
launched inside their spans, and the least time their calls could take.

The program opens ``hat.window_attention`` around each HAB's bias gather
and attention, and ``hat.overlap_attention`` around each OCAB's overlapping
key and value windows, bias gather and attention (``models/hat.py``); under
the profiler each is a ``user_annotation`` on the launching thread.  A
device operation belongs to the attention when the host call that launched
it (linked by the trace's correlation id) starts inside one of them, as
``spans_segment.by_phase`` links kernels to phases.

The work is read off the configuration's plain reference, as
``schedule.request`` reads the six ops': a forward on the meta device at
the request's device shape, with a forward hook on each of the reference's
``Attend`` modules, which both attentions call.  A call's least time is the
largest of its bytes (q, k, v and the output once each, and its module's
float32 bias table) over the card's memory rate, the FLOPs of its two
products over the dtype's peak, and its exponentials (B_ * heads * Nq *
Nk) at ``roofline``'s rate.

The program counts its attention calls and their logits
(``_attend.calls``, ``_attend.logit_elements``); ``counted`` holds them to
the reference's over every request the serving run made.
"""

from __future__ import annotations

import bisect
import functools
import sys
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

from port_bench import roofline, trace
from port_bench.harness import build_reference, reference_path
from port_bench.reference.step import bucket_of

SPANS = ("hat.window_attention", "hat.overlap_attention")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


class Call(NamedTuple):
    """One attention call: q (b, heads, nq, d), k and v (b, heads, nk,
    d), its module's bias table of ``table`` elements."""

    b: int
    heads: int
    nq: int
    nk: int
    d: int
    table: int

    @property
    def logits(self) -> int:
        return self.b * self.heads * self.nq * self.nk

    def counts(self, es: int) -> Dict[str, int]:
        """bytes, flops, exps with activations of ``es`` bytes."""
        q = self.b * self.heads * self.nq * self.d
        kv = self.b * self.heads * self.nk * self.d
        return {"bytes": (2 * q + 2 * kv) * es + 4 * self.table,
                "flops": 4 * self.logits * self.d, "exps": self.logits}


def _freeze(widths: Mapping) -> Tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in widths.items()))


def _thaw(frozen: Tuple) -> Dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in frozen}


@functools.lru_cache(maxsize=None)
def _calls(reference: Optional[str], model: str, widths: Tuple,
           batch: int, size: int) -> Tuple[Call, ...]:
    g = build_reference(reference, model, "meta", _thaw(widths)).eval()
    calls: List[Call] = []
    handles = []
    for name, m in g.named_modules():
        if type(m).__name__ != "Attend":
            continue
        owner = g.get_submodule(name.rpartition(".")[0])
        table = owner.relative_position_bias_table.numel()

        def hook(module, inputs, out, table=table):
            q, k = inputs[0], inputs[1]
            b, heads, nq, d = q.shape
            calls.append(Call(b, heads, nq, k.shape[2], d, table))
        handles.append(m.register_forward_hook(hook))
    try:
        with torch.no_grad():
            g(torch.empty(batch, 3, size, size, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return tuple(calls)


def calls(config: Mapping, batch: int, size: int) -> Tuple[Call, ...]:
    """The attention calls of one request of ``batch`` images padded to
    ``size`` square."""
    return _calls(reference_path(config), config["model"],
                  _freeze(config["widths"]), batch, size)


def bound_s(request_calls, dtype: str, max_sm_mhz: float) -> float:
    """The least seconds the calls could take on the card, activations in
    ``dtype`` ("float32" or "bfloat16")."""
    es = 2 if dtype == "bfloat16" else 4
    rate = roofline.exps_rate(max_sm_mhz)
    total = 0.0
    for c in request_calls:
        n = c.counts(es)
        total += max(n["bytes"] / roofline.PEAK_BYTES_PER_S,
                     n["flops"] / roofline.PEAK_FLOPS[dtype],
                     n["exps"] / rate)
    return total


def device_s(tr: trace.Trace) -> Tuple[float, float]:
    """(seconds of the window's device operations launched inside the
    attention spans, seconds of all of them), each operation's duration
    clipped to the window and summed."""
    window = next(e for e in tr.host() if e["name"] == trace.WINDOW_SPAN)
    spans = sorted((trace.interval(e) for e in tr.host()
                    if e.get("cat") == "user_annotation"
                    and e["name"] in SPANS
                    and (e.get("pid"), e.get("tid"))
                    == (window.get("pid"), window.get("tid"))))
    starts = [a for a, _ in spans]

    def inside(ts: float) -> bool:
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= spans[i][1]
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in tr.events
              if e.get("cat") in LAUNCH_CATEGORIES and e.get("ph") == "X"
              and "correlation" in e.get("args", {})}
    under = total = 0.0
    for e in tr.device():
        a, b = trace.interval(e)
        s = max(0.0, min(b, tr.end) - max(a, tr.start)) / 1e6
        total += s
        c = e.get("args", {}).get("correlation")
        if c in launch and inside(launch[c]):
            under += s
    return under, total


def counted(config: Mapping, buckets, measured: Mapping) -> Optional[str]:
    """Why the program's attention counters disagree with the reference's
    calls over every request of the serving run, or None where they
    agree.  The run warms up each device shape of the deck twice (the
    traced block holds every shape), then sends the window's requests and
    the traced ones."""
    from sradsgan_tpu_torch.models import hat

    got = (getattr(hat._attend, "calls", None),
           getattr(hat._attend, "logit_elements", None))
    if None in got:
        return "the program's HAT counts no attention calls"
    traced = [tuple(s) for s in measured["traced_shapes"]]
    window = [(k, bucket_of(buckets, h, w))
              for k, h, w in measured["request_shapes"]]
    want = [0, 0]
    for shape in sorted(set(traced)) * 2 + window + traced:
        for c in calls(config, *shape):
            want[0] += 1
            want[1] += c.logits
    if list(got) != want:
        return (f"the program made {got[0]} attention calls of "
                f"{got[1]} logits, the reference {want[0]} of {want[1]}")
    return None


def warn(why: str) -> None:
    print(f"attention: {why}", file=sys.stderr)
