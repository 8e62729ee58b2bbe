"""What every cell shares: finding its files by name, the device record,
the comparison against limits, and the result line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "sradsgan_tpu")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix,
    limits and metric entries, all read from their files."""

    name: str
    root: Path  # the benchmark's directory: configs/, traffic/, ...
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, manifest_path: Path) -> Cell:
    """The cell ``name`` of the manifest: its configuration from the file
    the manifest names, its mix from ``traffic/<traffic>.json``, its limits
    from ``limits/<cell>.json`` (both in the manifest's first path), and
    the metrics it reports."""
    manifest = load_json(manifest_path)
    base = Path(manifest_path).resolve().parent
    root = base / manifest["paths"][0]
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in {manifest_path}")
    config = next(c for c in manifest["configs"]
                  if c["name"] == entry["config"])
    cfg = load_json(base / config["file"])
    traffic = load_json(root / "traffic" / f"{entry['traffic']}.json")

    def reports(metric: Mapping) -> bool:
        return name in metric.get("workloads", [name])

    e2e = [m for m in manifest["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if reports(m) and m["moves"] in e2e_names]
    return Cell(name, root, entry["chips"], cfg, traffic,
                load_json(root / "limits" / f"{name}.json"), e2e, layer)


def metric_reader(name: str, root: Path) -> Callable:
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(cell: Cell, ctx: Mapping) -> Dict[str, Dict]:
    """Each per-layer metric of the cell that its reader finds something
    to read for; the others are left out."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], cell.root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``sradsgan_tpu_torch`` is not
    ``sradsgan_tpu``)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN_MODULES)


def card_info() -> Dict[str, str]:
    """Name, power limit and highest SM clock of card 0, as nvidia-smi
    gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0",
             "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return {}
    name, power, clock = (s.strip() for s in out.split(","))
    return {"name": name, "power_limit_w": power, "max_sm_mhz": clock}


def check(readings: Mapping[str, float],
          limits: Mapping[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit; a number that was not read,
    or is not finite, is null."""
    def value(k):
        v = readings.get(k)
        return v if v is not None and math.isfinite(v) else None
    return {k: {"value": value(k), "limit": limits[k]} for k in limits}


def passed(checked: Mapping[str, Mapping[str, float]]) -> bool:
    """Every number at or under its limit (a null one fails)."""
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checked.values())


def emit(result: Dict, checked: Mapping[str, Mapping[str, float]]) -> None:
    """The check's numbers as the last lines of standard error, and the
    result as the last line of standard output, the check last in it."""
    for k, c in checked.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "check": dict(checked)}), flush=True)


def fail_forbidden() -> Optional[int]:
    found = forbidden_modules()
    if found:
        print(f"port_bench: the process holds {found}", file=sys.stderr)
        return 3
    return None
