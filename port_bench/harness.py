"""What every cell shares: finding its files by name, the device record,
the comparison against limits, and the result line."""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Mapping, Optional

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "sradsgan_tpu")
ROOT = Path(__file__).resolve().parent  # the benchmark's own directory
# a recipe's "gan": "wgan-gp" trains G against the CBAM D with VGG19's
# content loss; "none" (or no key) is a pixel-only step of G
RECIPES = ("wgan-gp", "none")


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
    the metrics it reports.  A configuration's ``reference``, a path under
    that first path, is made absolute."""
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
    if "reference" in cfg:
        cfg["reference"] = str(root / cfg["reference"])
    traffic = load_json(root / "traffic" / f"{entry['traffic']}.json")

    def reports(metric: Mapping) -> bool:
        return name in metric.get("workloads", [name])

    e2e = [m for m in manifest["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if reports(m) and m["moves"] in e2e_names]
    return Cell(name, root, entry["chips"], cfg, traffic,
                load_json(root / "limits" / f"{name}.json"), e2e, layer)


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path``, loaded by path as the module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path) -> Callable:
    """``read(ctx)`` of ``metrics/<name>.py``."""
    return load_module(root / "metrics" / f"{name}.py",
                       f"port_bench_metric_{name.replace('.', '_')}").read


def reference_path(config: Mapping) -> Optional[str]:
    """The configuration's own plain reference, its ``reference`` resolved
    against the benchmark's directory (``load_cell`` has made it absolute
    already); None for the built-in generators of ``reference/models.py``."""
    ref = config.get("reference")
    return None if ref is None else str(ROOT / ref)


@functools.lru_cache(maxsize=None)
def reference_module(path: str) -> ModuleType:
    """A configuration's reference module, loaded once a process: it gives
    ``build(device, **widths)``, the generator with uninitialised storage,
    and ``TINY_WIDTHS``, its widths for the CPU copies."""
    return load_module(Path(path), f"port_bench_reference_{Path(path).stem}")


def build_reference(path: Optional[str], model: str, device,
                    widths: Mapping):
    """The reference generator with uninitialised storage on ``device``:
    the module at ``path``'s, or the built-in ``model``."""
    if path is None:
        from port_bench.reference.models import build
        return build(model, device, **widths)
    return reference_module(path).build(device, **widths)


def build_generator(config: Mapping, device):
    """The configuration's reference generator, uninitialised, on
    ``device``."""
    return build_reference(reference_path(config), config["model"], device,
                           config["widths"])


def adversarial(config: Mapping) -> bool:
    """Whether the configuration's recipe trains a D (``RECIPES``)."""
    gan = config.get("recipe", {}).get("gan", "none")
    if gan not in RECIPES:
        raise ValueError(f"the harness has no recipe {gan!r}; it has "
                         f"{RECIPES}")
    return gan != "none"


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
