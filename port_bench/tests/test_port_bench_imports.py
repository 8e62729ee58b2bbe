"""Nothing the command imports, and nothing the reference imports, has the
top-level name of JAX, Flax or the JAX package; the reference imports
nothing of the program.  Names are compared whole: ``sradsgan_tpu_torch``
begins with ``sradsgan_tpu`` and is the program."""

import json
import os
import subprocess
import sys
from pathlib import Path

from port_bench import harness
from port_bench.tests.dropin import add_edsr
from port_bench.tests.tiny import float32_copy, run_process

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "sradsgan_tpu"}


def top_level(modules: str) -> set:
    code = (f"import sys; import {modules}; import json; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_command_imports_no_jax():
    mods = top_level("port_bench.run, port_bench.train, port_bench.serve, "
                     "port_bench.calibrate, port_bench.flops, "
                     "sradsgan_tpu_torch.train.trainer, "
                     "sradsgan_tpu_torch.serving")
    assert not mods & FORBIDDEN
    assert "sradsgan_tpu_torch" in mods  # compared whole, not by prefix


def test_reference_imports_neither_jax_nor_the_program():
    mods = top_level("port_bench.reference.models, port_bench.reference.step")
    assert not mods & (FORBIDDEN | {"sradsgan_tpu_torch"})


def reference_files(manifest: Path) -> list:
    """The reference module of every configuration of ``manifest`` that
    names one, as ``load_cell`` resolves it."""
    m = json.loads(manifest.read_text())
    files = []
    for w in m["workloads"]:
        path = harness.reference_path(harness.load_cell(w["name"],
                                                        manifest).config)
        if path is not None and path not in files:
            files.append(path)
    return files


def test_every_configured_reference_imports_neither_jax_nor_the_program(
        tmp_path):
    """Each reference file a configuration names, of the repo's manifest
    and of a copy with the EDSR drop-in, loaded by path as the harness
    loads it, in a fresh interpreter."""
    manifest = float32_copy(tmp_path)
    add_edsr(manifest)
    files = reference_files(REPO / "BENCHMARK.json") + reference_files(
        manifest)
    assert files and files[-1].endswith("edsr.py")
    for path in files:
        code = ("import sys, json; from port_bench import harness; "
                f"m = harness.reference_module({path!r}); "
                "assert callable(m.build) and m.TINY_WIDTHS; "
                "print(json.dumps(sorted({n.split('.')[0] "
                "for n in sys.modules})))")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, check=True,
                             cwd=REPO).stdout
        mods = set(json.loads(out.strip().splitlines()[-1]))
        assert "torch" in mods, path
        assert not mods & (FORBIDDEN | {"sradsgan_tpu_torch"}), path


def test_the_harness_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sradsgan_tpu_torch_probe", object())
    assert "sradsgan_tpu_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sradsgan_tpu.models", object())
    assert "sradsgan_tpu.models" in harness.forbidden_modules()
    assert harness.fail_forbidden() is not None


def test_no_cards_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "sradsgan_x4.train_b16", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    if proc.returncode == 0:  # a machine with a card runs the cell
        return
    assert proc.stdout.strip() == ""


JAX_METRIC = '''"""A per-layer reader that loads JAX."""

import jax  # noqa: F401


def read(ctx):
    return 1.0
'''


def test_a_metric_reader_that_loads_jax_leaves_no_result(tmp_path):
    """The check comes after the readers have run: a drop-in reader that
    imports JAX (here a stand-in module of that name) makes the run print
    nothing and fail."""
    fake = tmp_path / "site" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text("")
    (tmp_path / "bench").mkdir()
    manifest = float32_copy(tmp_path / "bench")
    bench = manifest.parent / "port_bench"
    (bench / "metrics" / "loads_jax.train.py").write_text(JAX_METRIC)
    m = json.loads(manifest.read_text())
    cell = "sradsgan_x4.train_b16"
    m["per_layer"].append({"name": "loads_jax.train", "unit": "%",
                           "better": "lower", "source": "host_clock",
                           "layer": "train step", "moves": "train_mpix_s",
                           "workloads": [cell]})
    manifest.write_text(json.dumps(m))
    path = ":".join(p for p in (str(fake.parent), str(REPO),
                                os.environ.get("PYTHONPATH")) if p)
    proc = run_process(manifest, cell, trace=1,
                       extra_env={"PYTHONPATH": path})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "jax" in proc.stderr.strip().splitlines()[-1]
