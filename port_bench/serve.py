"""The serving cells: one client in a closed loop calling the program's
``Predictor`` with a deck of requests, each sent when the last returned.

Set-up builds the generator with the benchmark's weights and the predictor
with the mix's buckets and warms up every device shape the deck uses.  A
sample of the requests finished in the window, drawn from the seed with
the largest among them, is compared with the reference once the window has
closed.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import compare, trace
from port_bench.harness import Cell, build_generator
from port_bench.reference.step import bucket_of, serve as reference_serve
from port_bench.traffic import check_sample, request_deck
from port_bench.weights import make_weights


def generator_weights(config, seed: int, device) -> Dict:
    return make_weights(build_generator(config, device), seed, "generator")


def program_predictor(config, mix, weights, device):
    """The program's predictor, in the configuration's serving precision,
    over a generator holding the benchmark's weights."""
    from sradsgan_tpu_torch.models import create_generator
    from sradsgan_tpu_torch.serving import Predictor

    if config["precision"]["serve_dtype"] != "float32":
        raise ValueError("the configuration serves in a precision this "
                         "harness does not set up")
    g = create_generator(config["model"], config["scale"], device=device,
                         **config["widths"])
    g.load_state_dict(weights)
    return Predictor(g, config["scale"], buckets=mix["buckets"],
                     device=device, dtype=torch.float32)


def device_shape(req, buckets):
    """(batch, bucket): the shape a request runs on the device at."""
    k, h, w, _ = req.lr.shape
    return k, bucket_of(buckets, h, w)


def device_shapes(deck, buckets):
    """One request of each (batch, bucket) shape the deck sends."""
    seen = {}
    for req in deck:
        seen.setdefault(device_shape(req, buckets), req)
    return list(seen.values())


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        save_dir: str, call_hook: Optional[Callable] = None) -> Dict:
    """One run of a serving cell.  ``call_hook`` wraps the predictor's
    call (a test plants faults through it)."""
    config, mix = cell.config, cell.traffic
    weights = generator_weights(config, seed, device)
    predictor = program_predictor(config, mix, weights, device)
    call = predictor if call_hook is None else call_hook(predictor)
    deck = request_deck(mix, seed)
    for req in device_shapes(deck, mix["buckets"]) * 2:
        call(req.lr)
    _sync(device)
    setup_done = time.perf_counter()

    # the window: requests back to back, each timed to its host array
    latencies, outputs = [], {}
    attempted = failed = 0
    out_pixels = 0
    scale2 = config["scale"] ** 2
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = attempted % len(deck)
        req = deck[i]
        attempted += 1
        s = time.perf_counter()
        try:
            with record_function("bench.request"):
                out = call(req.lr)
        except Exception as e:  # noqa: BLE001 - a failed request is counted
            failed += 1
            print(f"request {i} failed: {e!r}", file=sys.stderr)
            continue
        latencies.append(time.perf_counter() - s)
        out_pixels += req.lr_pixels * scale2
        if attempted <= len(deck):  # a request's first answer is compared
            outputs[i] = out
    window_s = time.perf_counter() - t0

    measured = {"attempted": attempted, "failed": failed,
                "latencies_s": latencies, "window_s": window_s,
                "setup_done": setup_done,
                "mpix_s": out_pixels / 1e6 / window_s,
                "out_pixels": out_pixels,
                "request_shapes": [deck[i % len(deck)].lr.shape[:3]
                                   for i in range(attempted)]}
    if traced:
        # from the next block's start: the traced requests are one block,
        # every shape of the mix in its proportion
        block = len(deck) // mix["blocks"]
        first = -(-attempted // block) * block
        traced_reqs = [deck[(first + j) % len(deck)]
                       for j in range(mix["traced_requests"])]

        def segment():
            for req in traced_reqs:
                with record_function("bench.request"):
                    call(req.lr)
        tr = trace.run_traced(segment, save_dir)
        measured.update(trace=tr, busy_s=trace.busy_s(tr),
                        traced_lr_pixels=[r.lr_pixels for r in traced_reqs],
                        traced_shapes=[device_shape(r, mix["buckets"])
                                       for r in traced_reqs])
    if torch.device(device).type == "cuda":
        measured["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            device))
    else:
        measured["memory_peak_bytes"] = 0
    del predictor, call
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    sample = check_sample(deck, sorted(outputs), mix["check_sample"], seed)
    measured["compared"] = len(sample)
    check_inputs = {"weights": weights,
                    "inputs": [deck[i].lr for i in sample],
                    "outputs": [outputs[i] for i in sample]}
    measured["check_inputs"] = check_inputs
    ref = reference(config, mix, check_inputs, device)
    measured["readings"] = {"output_gap": compare.output_gap(
        check_inputs["outputs"], ref) if ref else float("inf")}
    return measured


def reference(config, mix, check_inputs, device):
    """The reference's answers to the sampled requests."""
    g = build_generator(config, device)
    g.load_state_dict(check_inputs["weights"])
    g.eval()
    return [reference_serve(g, lr, mix["buckets"], config["scale"], device)
            for lr in check_inputs["inputs"]]


def p95(values) -> float:
    """The 95th percentile (linear interpolation between order
    statistics)."""
    return float(np.percentile(np.asarray(values), 95))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
