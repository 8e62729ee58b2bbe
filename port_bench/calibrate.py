"""The readings that the limits of ``correct`` are set from: the program's
compared numbers over many seeds (the lower reading), and the control's and
each planted fault's (the upper), at the cell's own size.

    python3 -m port_bench.calibrate --workload <cell> --seeds N [--first S]
        [--controls K]

Each seed runs the cell's set-up and check without a measured window
(training) or with a short one at the cell's load (serving,
``--seconds``).  For the first ``--controls`` seeds it also reads, each in
the program's place:

- training: the control, the reference with every product's operands
  rounded to float8 e4m3 (the precision below the configuration's bf16);
  the faults ``half_batch`` (the reference on the first half of each
  batch), ``g_sign`` (the G's gradient negated before its update) and
  ``no_dq`` (no gradient through the position attention's queries, as
  its backward kernel would give with dq left zero).  A step that returns
  its state unchanged reads 1 on ``change_gap`` by the measure and needs
  no run;
- serving: the control, the reference with TF32 on (the precision below
  the configuration's float32 with TF32 off).

One JSON line a seed, then a summary: each number's largest sound reading
and smallest control or fault reading.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
from typing import Dict, List

import torch

from port_bench import compare, harness, run, serve, train
from port_bench.reference import models
from port_bench.reference.models import Numerics

STRIDE = 1_000_003  # seeds S, S + STRIDE, ...


@contextlib.contextmanager
def no_dq():
    """The reference's position attention with no gradient through its
    queries (the query conv stays in the graph, its gradient zero)."""
    attend = models.SpatialSelfAttention.attend
    models.SpatialSelfAttention.attend = (
        lambda self, q, k, v: attend(self, q.detach() + 0 * q, k, v))
    try:
        yield
    finally:
        models.SpatialSelfAttention.attend = attend


def train_upper(cell, measured, device) -> Dict[str, Dict[str, float]]:
    config, batch = cell.config, cell.traffic["batch"]
    ci = measured["check_inputs"]

    def read(**fault):
        return compare.train_readings(
            train.reference(config, ci, batch, device, **fault), exact,
            config)
    exact = train.reference(config, ci, batch, device)
    out = {"control": read(numerics=Numerics(fp8=True)),
           "half_batch": read(rows=slice(0, batch // 2)),
           "g_sign": read(g_grads=lambda gs: [-g for g in gs])}
    with no_dq():
        out["no_dq"] = read()
    return out


def serve_upper(cell, measured, device) -> Dict[str, Dict[str, float]]:
    ci = measured["check_inputs"]
    exact = serve.reference(cell.config, cell.traffic, ci, device)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = serve.reference(cell.config, cell.traffic, ci, device)
    finally:
        run.precision_flags()
    return {"control": {"output_gap": compare.output_gap(tf32, exact)}}


def summary(rows: List[Dict]) -> Dict:
    lower: Dict[str, float] = {}
    upper: Dict[str, Dict[str, float]] = {}
    for row in rows:
        for k, v in row["program"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for name, readings in row.get("upper", {}).items():
            for k, v in readings.items():
                upper.setdefault(name, {})
                upper[name][k] = min(upper[name].get(k, float("inf")), v)
    return {"lower": lower, "upper": upper, "seeds": len(rows)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="port_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=2_147_483_659)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload, run.MANIFEST)
    if torch.device(args.device).type == "cuda":
        torch.cuda.set_device(args.device)
    run.precision_flags()
    kind = cell.traffic["kind"]
    rows = []
    with tempfile.TemporaryDirectory() as save_dir:
        for i in range(args.seeds):
            seed = args.first + i * STRIDE
            if kind == "train":
                measured = train.run(cell, seed, 0.0, False, args.device,
                                     save_dir)
            else:
                measured = serve.run(cell, seed, args.seconds, False,
                                     args.device, save_dir)
            row = {"seed": seed, "program": measured["readings"]}
            if i < args.controls:
                upper = train_upper if kind == "train" else serve_upper
                row["upper"] = upper(cell, measured, args.device)
            print(json.dumps(row), flush=True)
            rows.append(row)
            del measured
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
