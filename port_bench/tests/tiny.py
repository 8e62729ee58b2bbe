"""A copy of the benchmark at tiny widths and sizes, for runs on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, Mapping

from port_bench.harness import reference_module

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent

# the built-in generators' (reference/models.py); a configuration's own
# reference gives its TINY_WIDTHS
TINY_WIDTHS = {"sradsgan": {"base_filters": 16, "n_groups": 1, "n_blocks": 1},
               "sragan": {"base_filters": 16, "n_groups": 1, "n_blocks": 2}}
TINY_TRAFFIC = {
    "train": {"batch": 4, "lr_size": 8, "images": 16, "workers": 2,
              "traced_steps": 2},
    "serve": {"requests": [{"count": 3, "batch": 1, "height": 8,
                            "width": 8},
                           {"count": 1, "batch": 2, "height": 11,
                            "width": 16}],
              "blocks": 2, "buckets": [8, 12, 16], "check_sample": 4,
              "traced_requests": 4},
}


def tiny_widths(config: Mapping, bench: Path) -> Dict:
    """The configuration's widths for the CPU copies: its reference
    module's ``TINY_WIDTHS`` (the module a path under ``bench``), or
    TINY_WIDTHS for a built-in generator."""
    if "reference" in config:
        return dict(reference_module(str(bench / config["reference"]))
                    .TINY_WIDTHS)
    return TINY_WIDTHS[config["model"]]


def tiny_copy(tmp: Path) -> Path:
    """``tmp/BENCHMARK.json`` and ``tmp/port_bench``: the repo's manifest
    and files with every configuration cut to its tiny widths and every mix
    to TINY_TRAFFIC; returns the manifest's path."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (tmp / "port_bench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["widths"] = tiny_widths(cfg, tmp / "port_bench")
        path.write_text(json.dumps(cfg))
    for path in (tmp / "port_bench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(TINY_TRAFFIC[mix["kind"]])
        path.write_text(json.dumps(mix))
    return tmp / "BENCHMARK.json"


def float32_copy(tmp: Path) -> Path:
    """:func:`tiny_copy` with the training configurations in float32, so
    that a sound run of the program reads at rounding level against the
    reference, whatever the cell's limits."""
    manifest = tiny_copy(tmp)
    for path in (tmp / "port_bench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["precision"]["train_bf16"] = False
        path.write_text(json.dumps(cfg))
    return manifest


def run_cell(manifest: Path, cell: str, seed: int = 2147483659,
             seconds: float = 0.5, trace: int = 0, plant: str = "",
             extra_env=None):
    """One run of a cell of ``manifest`` on the CPU in a fresh
    interpreter; returns (exit code, the result line or None, stderr)."""
    proc = run_process(manifest, cell, seed, seconds, trace, plant,
                       extra_env)
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, line, proc.stderr


def run_process(manifest: Path, cell: str, seed: int = 2147483659,
                seconds: float = 0.5, trace: int = 0, plant: str = "",
                extra_env=None):
    """:func:`run_cell`'s finished process."""
    import os
    import subprocess
    import sys

    code = ("import sys; from pathlib import Path; "
            "from port_bench.run import main; "
            "sys.exit(main(sys.argv[2:], Path(sys.argv[1])))")
    env = dict(os.environ, OMP_NUM_THREADS="1", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "-c", code, str(manifest), "--workload", cell,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace), "--device", "cpu", "--plant", plant],
        cwd=REPO, capture_output=True, text=True, env=env, timeout=900)
