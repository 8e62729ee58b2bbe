"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read after the window from a traced
segment of a fixed number of steps or requests.  The command needs as many
CUDA devices as the cell's chips, and turns TF32 off before the program is
built.  It prints no result if the process holds JAX, Flax or the JAX
package once everything the line needs has been worked out.
"""

import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import torch  # noqa: E402

from port_bench import faults, harness, trace  # noqa: E402
from port_bench.harness import Cell  # noqa: E402

MANIFEST = Path(__file__).resolve().parent.parent / "BENCHMARK.json"


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the CPU, for tests: no look for cards
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    # a fault planted under the timed path (faults.py), for tests
    p.add_argument("--plant", default="", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def precision_flags() -> None:
    """float32 products in float32: TF32 off, as each configuration
    states."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def launches() -> Dict[str, int]:
    """The program's own launch counters of its six kernels."""
    from sradsgan_tpu_torch.ops import pooling, rab_tail, sgam_flash
    from sradsgan_tpu_torch.ops import spatial_gate as sg
    fns = (pooling.avg_max_pool_cuda, sg.spatial_gate_cuda,
           sg.spatial_gate_bwd_cuda, sgam_flash.position_attention_cuda,
           sgam_flash.position_attention_bwd_cuda, rab_tail.rab_tail_cuda)
    return {f.__name__: f.launches for f in fns}


def end_to_end(cell: Cell, measured: Dict) -> Dict[str, Dict]:
    from port_bench.serve import p95
    values = {"setup_s": measured["setup_done"] - T_START}
    if cell.traffic["kind"] == "train":
        values["train_mpix_s"] = measured["mpix_s"]
    else:
        values["serve_mpix_s"] = measured["mpix_s"]
        values["request_p95_ms"] = 1e3 * p95(measured["latencies_s"])
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def result(cell: Cell, measured: Dict, traced: bool, device) -> Dict:
    card = harness.card_info()
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": measured["memory_peak_bytes"]}
    out = {"correct": False,
           "attempted": measured.get("attempted", measured.get("steps", 0)),
           "failed": measured.get("failed", 0)}
    if traced:
        tr = measured["trace"]
        ctx = {"cell": cell, "measured": measured, "trace": tr,
               "card": card, "chips": cell.chips}
        out["metrics"] = harness.read_metrics(cell, ctx)
        dev.update(busy_s=measured["busy_s"], window_s=tr.window_s)
        out["device"] = dev
        out["breakdown"] = trace.breakdown(tr)
    else:
        out["metrics"] = end_to_end(cell, measured)
        out["device"] = dev
    print(f"card {json.dumps(card)} launches {json.dumps(launches())}",
          file=sys.stderr)
    return out


def main(argv: Optional[List[str]] = None, manifest: Path = MANIFEST) -> int:
    args = parse(argv)
    cell = harness.load_cell(args.workload, manifest)
    hooks = faults.hooks(args.plant)
    device = args.device
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            print(f"port_bench: {args.workload} needs {cell.chips} CUDA "
                  "device(s)", file=sys.stderr)
            return 2
        device = "cuda:0"
        torch.cuda.set_device(device)
    precision_flags()
    with tempfile.TemporaryDirectory() as save_dir:
        measured = _run(cell, args, device, save_dir, hooks)
        out = result(cell, measured, bool(args.trace), device)
    checked = harness.check(measured["readings"], cell.limits)
    out["correct"] = harness.passed(checked)
    # last: every module the line needed, the metric readers too, is loaded
    bad = harness.fail_forbidden()
    if bad is not None:
        return bad
    harness.emit(out, checked)
    return 0


def _run(cell: Cell, args, device, save_dir: str, hooks: Dict) -> Dict:
    kind = cell.traffic["kind"]
    if kind == "train":
        from port_bench import train
        return train.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, save_dir, hooks.get("step"))
    if kind == "serve":
        from port_bench import serve
        return serve.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, save_dir, hooks.get("call"))
    raise SystemExit(f"unknown traffic kind {kind!r}")


if __name__ == "__main__":
    sys.exit(main())
