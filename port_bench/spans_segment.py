"""The program's phases with the profiler off: a spans segment, and a
one-time table of what each phase costs the host and the device.

The program's spans (``sradsgan_tpu_torch/utils/spans.py``) name the
phases of a train step (``train.step`` over ``train.g_forward``, ...) and of
a request (``serve.request`` over ``serve.pad``, ...).  Under
``torch.profiler`` with shapes recorded, the host's time in a phase is
the profiler's as much as the program's (in the autograd backward most
of it), so a phase's host time is read here from a recording with the
profiler off. One profiled segment after it gives each phase's device
time and kernels, a kernel going to the innermost span on the segment's
thread that holds the start of the call that launched it, on any thread.

    python3 -m port_bench.spans_segment --workload sradsgan_x4.train_b16 \\
        --seed 3600000001 [--rounds 8 --per 12] [--device cuda:0] [--out DIR]

prints one JSON line and writes the whole record to
``DIR/<workload>.<seed>.json`` (``spans_segment/``): ``span()``'s cost a
call, off and recorded; the units' wall ms with spans off and recorded, in
turns in one process; each phase's host ms a unit (medians, recorded, and
under the profiler); and the profiled segment's device ms, kernels and
heaviest kernels by phase.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import statistics
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List

import torch

from port_bench import harness, trace
from port_bench.run import MANIFEST, precision_flags
from port_bench.weights import sub_seed
from sradsgan_tpu_torch.utils import spans


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def per_unit_ms(records: List[spans.Span]) -> List[Dict[str, float]]:
    """For each root span of a recording, in order: the summed host ms of
    each span name inside it, the root's own included."""
    units: Dict[int, Dict[str, float]] = {}
    for s in records:
        u = units.setdefault(s.root, {})
        u[s.name] = u.get(s.name, 0.0) + s.ns / 1e6
    return [units[k] for k in sorted(units)]


def by_name(recordings: List[List[spans.Span]]) -> Dict[str, List[float]]:
    """Each span name's host ms in every unit of the recordings."""
    out: Dict[str, List[float]] = defaultdict(list)
    for records in recordings:
        for unit in per_unit_ms(records):
            for name, ms in unit.items():
                out[name].append(ms)
    return out


def root_self_ms(records: List[spans.Span]) -> List[float]:
    """Each root span's host ms outside its children."""
    kids: Dict[int, int] = defaultdict(int)
    for s in records:
        kids[s.parent] += s.ns
    return [(s.ns - kids[s.index]) / 1e6 for s in records if s.parent == -1]


def span_cost_ns(n: int = 200000) -> Dict[str, float]:
    """``span()``'s cost a call, off and recorded, beside an empty call."""
    def one():
        with spans.span("x"):
            pass

    def empty():
        pass
    out = {}
    for key, fn, on in (("off_ns", one, False), ("recorded_ns", one, True),
                        ("empty_call_ns", empty, False)):
        with spans.recording(limit=1024) if on else contextlib.nullcontext():
            t = time.perf_counter_ns()
            for _ in range(n):
                fn()
            out[key] = (time.perf_counter_ns() - t) / n
    return out


def unit_of(cell: harness.Cell, seed: int, device, save_dir: str):
    """The cell's unit of work as the window runs it, one train step or one
    request a call; its count in the traced segment; what to close."""
    config, mix = cell.config, cell.traffic
    if mix["kind"] == "train":
        from port_bench import train
        from port_bench.traffic import training_set
        trainer = train.program_trainer(
            config, mix, train.reference_weights(config, seed, device),
            device, save_dir)
        feed = train.Feed(training_set(mix, config["scale"], seed, device),
                          mix["batch"], mix["workers"],
                          sub_seed(seed, "data") % 2 ** 31, device)
        gen = torch.Generator().manual_seed(sub_seed(seed, "alpha"))

        def close():
            feed.close()
            trainer.logger.close()
        return (lambda: trainer.train_step(feed.next(), gen),
                mix["traced_steps"], close)
    from port_bench import serve
    from port_bench.traffic import request_deck
    predictor = serve.program_predictor(
        config, mix, serve.generator_weights(config, seed, device), device)
    deck = request_deck(mix, seed)
    count = iter(range(2 ** 62))
    return (lambda: predictor(deck[next(count) % len(deck)].lr),
            mix["traced_requests"], lambda: None)


def timed(unit: Callable, k: int, device) -> List[float]:
    """``k`` units back to back: each one's wall ms, start to start, the
    last to the device's end."""
    stamps = [time.perf_counter()]
    for _ in range(k):
        unit()
        stamps.append(time.perf_counter())
    _sync(device)
    stamps[-1] = time.perf_counter()
    return [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]


def quartiles(v: List[float]) -> Dict[str, float]:
    q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
    return {"median": statistics.median(v), "q1": q[0], "q3": q[2],
            "n": len(v)}


def by_phase(tr: trace.Trace, n: int) -> Dict:
    """The profiled segment's device ms and kernels a unit by the phase
    whose span holds the launching call's start, and the heaviest
    kernels' ms a unit by phase."""
    window = next(e for e in tr.host() if e["name"] == trace.WINDOW_SPAN)
    notes = sorted((e for e in tr.host() if e.get("cat") == "user_annotation"
                    and (e.get("pid"), e.get("tid"))
                    == (window.get("pid"), window.get("tid"))
                    and e["name"].split(".")[0] in ("train", "serve")),
                   key=lambda e: float(e["ts"]))
    starts = [float(e["ts"]) for e in notes]

    def phase(ts: float) -> str:
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0:
            lo, hi = trace.interval(notes[i])
            if lo <= ts <= hi:
                return notes[i]["name"]
            i -= 1
        return "no span"
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in tr.events
              if e.get("cat") == "cuda_runtime" and e.get("ph") == "X"
              and "correlation" in e.get("args", {})}
    device_ms: Dict[str, float] = defaultdict(float)
    kernels: Dict[str, float] = defaultdict(float)
    heavy: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    for e in tr.device():
        c = e.get("args", {}).get("correlation")
        p = phase(launch[c]) if c in launch else "unlinked"
        ms = float(e.get("dur", 0)) / 1e3 / n
        device_ms[p] += ms
        kernels[p] += (e.get("cat") == "kernel") / n
        heavy[e.get("name", "?")[:80]][p] += ms
    top = sorted(heavy.items(), key=lambda kv: -sum(kv[1].values()))[:12]
    return {"device_ms": dict(device_ms), "kernels": dict(kernels),
            "heaviest_kernels_ms": {k: dict(v) for k, v in top}}


def measure(cell: harness.Cell, seed: int, rounds: int, per: int,
            device, save_dir: str) -> Dict:
    unit, n_traced, close = unit_of(cell, seed, device, save_dir)
    try:
        timed(unit, 6, device)  # warm-up
        walls: Dict[str, List[float]] = {"off": [], "recorded": []}
        ratios, recordings = [], []
        for r in range(rounds):
            block = {}
            for mode in (("off", "recorded") if r % 2 == 0
                         else ("recorded", "off")):
                if mode == "off":
                    block[mode] = timed(unit, per, device)
                else:
                    with spans.recording() as records:
                        block[mode] = timed(unit, per, device)
                    recordings.append(records)
                walls[mode] += block[mode]
            ratios.append(statistics.median(block["recorded"])
                          / statistics.median(block["off"]))

        def seg():
            for _ in range(n_traced):
                unit()
            _sync(device)
        with spans.recording() as profiled:
            tr = trace.run_traced(seg, save_dir)
    finally:
        close()
    host, under = by_name(recordings), by_name([profiled])
    return {"wall_ms": {k: quartiles(v) for k, v in walls.items()},
            "recorded_over_off_by_turn": ratios,
            "host_ms": {k: quartiles(v) for k, v in host.items()},
            "root_self_ms": quartiles([ms for r in recordings
                                       for ms in root_self_ms(r)]),
            "host_ms_profiled": {k: statistics.median(v)
                                 for k, v in under.items()},
            "profiled": by_phase(tr, n_traced),
            "idle_gaps": trace.breakdown(tr)["idle_gaps"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--per", type=int, default=12)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--manifest", type=Path, default=MANIFEST)
    p.add_argument("--out", type=Path,
                   default=Path("spans_segment"))
    a = p.parse_args(argv)
    cell = harness.load_cell(a.workload, a.manifest)
    if torch.device(a.device).type == "cuda":
        torch.cuda.set_device(a.device)
    precision_flags()
    out = {"workload": a.workload, "seed": a.seed,
           "card": harness.card_info(), "span_cost_ns": span_cost_ns()}
    with tempfile.TemporaryDirectory() as save_dir:
        out.update(measure(cell, a.seed, a.rounds, a.per, a.device,
                           save_dir))
    a.out.mkdir(parents=True, exist_ok=True)
    (a.out / f"{a.workload}.{a.seed}.json").write_text(
        json.dumps(out, indent=1))
    line = {k: out[k] for k in ("workload", "card", "span_cost_ns",
                                "wall_ms", "root_self_ms")}
    line["host_ms"] = {k: v["median"] for k, v in out["host_ms"].items()}
    line["host_ms_profiled"] = out["host_ms_profiled"]
    line["device_ms"] = out["profiled"]["device_ms"]
    line["kernels"] = out["profiled"]["kernels"]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
