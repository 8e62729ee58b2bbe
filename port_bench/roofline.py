"""Published peaks of one NVIDIA H100 SXM and the least time each of the
program's six registered ops could take.

Peaks (NVIDIA's data sheet, dense, at the 700 W limit): 3.35 TB/s of HBM3,
989 TFLOP/s bf16, 495 TFLOP/s TF32 (the highest rate any float32
implementation could reach, taken as the float32 rate), exponentials at 16
a clock on each of the 132 multiprocessors at ``clocks.max.sm``.

An op's bound is the largest of its bytes over the memory rate, its
operations over its dtype's rate and its exponentials over theirs.  The
counts come from the op's input shapes: each input read once, each output
written once, the operations of the function (not what a kernel does
again); they are the counts ``chip_smoke.py`` holds the kernels to.

The share a cell reports is the bound of the work its traced segment had
to do, each unit's calls as ``schedule.py`` reads them off the reference,
over the device time of the program's own kernels in the segment, found
by name (``trace.kernel_s``), however the program launched them.
"""

from __future__ import annotations

from math import prod
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
EXPS_PER_CLOCK_PER_SM = 16
SMS = 132

OPS = ("avg_max_pool", "spatial_gate", "spatial_gate_bwd",
       "position_attention", "position_attention_bwd", "rab_tail")


def dtype_name(trace_type: str) -> str:
    """The trace's "Input type" of a tensor as a key of PEAK_FLOPS (the
    link through host op calls, which the tests hold the schedule to)."""
    return "bfloat16" if "BFloat16" in trace_type else "float32"


def counts(op: str, dims: Sequence[Sequence[int]], es: int) -> Dict:
    """(bytes, flops, exps) of one call from its input dims and the
    element size of its activations."""
    if op == "avg_max_pool":
        b, c = dims[0][:2]
        n = prod(dims[0])
        return {"bytes": (n + 2 * b * c) * es, "flops": 2 * n, "exps": 0}
    if op in ("spatial_gate", "spatial_gate_bwd"):
        b, _, h, w = dims[0]
        n, px = prod(dims[0]), b * h * w
        if op == "spatial_gate":
            return {"bytes": 2 * n * es + 98 * 4,
                    "flops": 3 * n + px * 2 * 98, "exps": 0}
        return {"bytes": 3 * n * es + 2 * 98 * 4,
                "flops": 8 * n + px * 6 * 98, "exps": 0}
    if op in ("position_attention", "position_attention_bwd"):
        b, n, d = dims[0]
        dv = dims[2][2]
        if op == "position_attention":
            return {"bytes": b * n * (2 * d + 2 * dv) * es,
                    "flops": 2 * b * n * n * (d + dv), "exps": b * n * n}
        return {"bytes": b * n * ((2 * d + dv) * 2 + 2 * dv) * es + b * n * 4,
                "flops": 2 * b * n * n * (3 * d + 2 * dv),
                "exps": b * n * n}
    if op == "rab_tail":
        b, c, h, w = dims[0]
        n, px = prod(dims[0]), b * h * w
        params = sum(prod(d) for d in dims[2:7])
        return {"bytes": 3 * n * es + 4 * (3 * px + 3 * b * c + params),
                "flops": px * (2 * c * c + 8 * c + 2 * 98), "exps": 0}
    raise KeyError(op)


def bound_s(op: str, dims, dtype: str, exps_per_s: float,
            with_lse: bool = False) -> float:
    """The least seconds a call could take on the card; ``dtype``: its
    activations' ("float32" or "bfloat16"); ``with_lse``: the forward also
    writes its log-sum-exp (float32), as the train step's does."""
    es = 2 if dtype == "bfloat16" else 4
    c = counts(op, dims, es)
    if op == "position_attention" and with_lse:
        c["bytes"] += dims[0][0] * dims[0][1] * 4
    return max(c["bytes"] / PEAK_BYTES_PER_S, c["flops"] / PEAK_FLOPS[dtype],
               c["exps"] / exps_per_s if c["exps"] else 0.0)


def exps_rate(max_sm_mhz: float) -> float:
    return EXPS_PER_CLOCK_PER_SM * SMS * max_sm_mhz * 1e6


def schedule_bound_s(entries: Iterable, max_sm_mhz: float) -> float:
    """The least seconds a unit's calls (``schedule.Entry``) could take."""
    rate = exps_rate(max_sm_mhz)
    return sum(bound_s(e.op, e.dims, e.dtype, rate, e.with_lse)
               for e in entries)


def share(bound: float, kernel_s: float) -> Optional[float]:
    """Percent: the least seconds of the work over the seconds its kernels
    took; None where no kernel of the program ran or the work has no call
    of the six functions."""
    return 100.0 * bound / kernel_s if kernel_s > 0 and bound > 0 else None


def roofline_share(calls: List[Mapping], max_sm_mhz: float
                   ) -> Optional[float]:
    """Percent, by the link through host op calls (``trace.op_calls``):
    the summed bounds of the calls over the summed device time of the
    kernels they launched; None where no call launched a kernel.  A CUDA
    graph's replay makes no op call, so this reads only eager calls; the
    tests hold the schedule's reading to it."""
    rate = exps_rate(max_sm_mhz)
    bound = spent = 0.0
    for call in calls:
        if not call["kernels"]:
            continue
        lse = "True" in map(str, call.get("concrete", []))
        dtype = dtype_name(call["types"][0] if call["types"] else "float")
        bound += bound_s(call["name"], call["dims"], dtype, rate, lse)
        spent += call["device_s"]
    return share(bound, spent)
