"""Rank worker of the data-parallel checks: W processes over one process
group take steps of the port's trainers and write what they saw, for a
comparison with one process at the global batch.

    python -m sradsgan_tpu_torch.tools.dp_check --rank R --world W \\
        --init file:///tmp/store --spec spec.json --out DIR

:func:`run_ranks` starts the W processes (each a fresh interpreter that
imports the port alone), waits for them against a deadline, kills them if it
passes (a rank that waits in a collective forever fails the check instead
of hanging it) and returns each rank's results.  The spec is JSON:
``{"device": "cpu" | "cuda:0", "backend": "gloo" | "nccl", "scenarios":
[...]}``, each scenario a dict with a ``kind``:

- ``"gan"``: :class:`~sradsgan_tpu_torch.train.trainer.Trainer` from
  ``config`` (a JSON file of ``config.save_config``), its weights from
  ``weights`` (a ``torch.save`` of ``generator``, ``discriminator`` and
  ``vgg`` state dicts) where given, ``steps`` train steps on the global
  batches of :func:`gan_batches` (``seed``, ``batch``, ``lr_size``), each
  step's penalty weights from a CPU generator seeded ``alpha_seed`` (the
  same weights every step, as a test hands the JAX step); it returns
  each step's losses and kernel launches, the first step's gradients and
  running statistics, and the final state dicts; with ``turns`` and
  ``timed_steps``, the step is then timed (:func:`_turn_ms`);
- ``"diffusion"``: :class:`~sradsgan_tpu_torch.diffusion.trainer.
  DiffusionTrainer` (``scale``, ``crop``, ``unet_kwargs``, ``timesteps``
  (default 1000), ``weights``: a UNet state dict), ``steps`` steps on
  :func:`diffusion_batches`, ``t`` and the noise drawn from a generator on
  the device seeded ``draw_seed``, timed likewise where the scenario asks;
- ``"epoch"``: ``Trainer.train()`` for ``config``'s epochs; it returns the
  steps taken, the last sweep's metrics and the final state dicts;
- ``"validate"``: ``Trainer.validate(max_batches)``;
- ``"tiled"``: ``evaluation.tiled.tiled_super_resolve`` over the mesh:
  the generator ``model`` at ``scale`` with ``model_kwargs``, its weights
  from ``weights`` (a state dict), in eval mode, on the scene that
  :func:`tiled_scene` makes from ``seed``, ``height`` and ``width``, cut
  at ``tile``, ``halo`` and ``batch_tiles``; it returns the scene every
  rank stitched and the kernel launches of that call; with ``turns`` (a
  list of ``"one"`` and ``"mesh"``), the call is then timed in those
  turns, ``"one"`` rank 0 alone without the group (the others wait),
  ``"mesh"`` every rank over the group (:func:`_tiled_turns`).

Every rank runs float32 without TF32, as the one process it is held
against.

``register_tiny`` registers a model of the registry with a discriminator of
other widths (``d_kwargs``), as the spec's ``tiny`` entry asks, in the
children and in a caller that compares with them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def kernel_wrappers() -> Dict[str, Any]:
    """The six launch wrappers, each counting its launches."""
    from sradsgan_tpu_torch.ops import (pooling, rab_tail, sgam_flash,
                                        spatial_gate)
    return {"avg_max_pool": pooling.avg_max_pool_cuda,
            "spatial_gate": spatial_gate.spatial_gate_cuda,
            "position_attention": sgam_flash.position_attention_cuda,
            "spatial_gate_bwd": spatial_gate.spatial_gate_bwd_cuda,
            "position_attention_bwd":
                sgam_flash.position_attention_bwd_cuda,
            "rab_tail": rab_tail.rab_tail_cuda}


def register_tiny(model: str, d_kwargs: Dict[str, Any]) -> str:
    """``model``'s recipe with ``PatchDiscriminator(**d_kwargs)``, registered
    as ``{model}_dp``; returns that name."""
    from sradsgan_tpu_torch import models
    from sradsgan_tpu_torch.models.discriminators import PatchDiscriminator

    d_kwargs = {k: tuple(map(tuple, v)) if k == "blocks" else v
                for k, v in d_kwargs.items()}
    name = f"{model}_dp"
    models.register(dataclasses.replace(
        models.get_spec(model), name=name,
        discriminator=lambda **kw: PatchDiscriminator(**d_kwargs, **kw)))
    return name


def gan_batches(seed: int, steps: int, batch: int, lr_size: int,
                scale: int) -> List[Dict[str, np.ndarray]]:
    """``steps`` global batches of NHWC float32 (lr, hr) in [0, 1]."""
    rng = np.random.default_rng(seed)
    hr = lr_size * scale
    return [{"lr": rng.random((batch, lr_size, lr_size, 3), dtype=np.float32),
             "hr": rng.random((batch, hr, hr, 3), dtype=np.float32)}
            for _ in range(steps)]


def diffusion_batches(seed: int, steps: int, batch: int,
                      size: int) -> List[Dict[str, np.ndarray]]:
    """``steps`` global batches of NHWC float32 (HR, SR) in [-1, 1]."""
    rng = np.random.default_rng(seed)
    return [{k: rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
             for k in ("HR", "SR")} for _ in range(steps)]


def tiled_scene(seed: int, height: int, width: int) -> np.ndarray:
    """An (height, width, 3) float32 LR scene in [0, 1]."""
    rng = np.random.default_rng(seed)
    return rng.random((height, width, 3), dtype=np.float32)


def _cpu_state(module: Optional[torch.nn.Module]) -> Dict[str, torch.Tensor]:
    if module is None:
        return {}
    return {k: v.detach().cpu().clone() for k, v in
            module.state_dict().items()}


def _grads(module: Optional[torch.nn.Module]) -> Dict[str, torch.Tensor]:
    if module is None:
        return {}
    return {n: p.grad.detach().cpu().clone()
            for n, p in module.named_parameters() if p.grad is not None}


def _stats(module: Optional[torch.nn.Module]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in _cpu_state(module).items()
            if k.endswith(("running_mean", "running_var"))}


def load_gan_weights(trainer, path: Optional[str]) -> None:
    if not path:
        return
    state = torch.load(path, map_location=trainer.device, weights_only=True)
    trainer.generator.load_state_dict(state["generator"])
    for key in ("discriminator", "vgg"):
        if key in state:
            getattr(trainer, key).load_state_dict(state[key])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _turn_ms(step, trainer, sc: Dict[str, Any]) -> List[float]:
    """ms a step (host clock, the last step's loss read) in each of
    ``sc["turns"]`` turns of ``sc["timed_steps"]`` steps, each turn begun
    behind a barrier of every rank and one untimed step; [] where the
    scenario asks for no timing."""
    times = []
    for _ in range(sc.get("turns", 0)):
        trainer.mesh.barrier()
        step()
        _sync(trainer.device)
        t0 = time.perf_counter()
        for _ in range(sc["timed_steps"]):
            loss = step()
        float(loss)  # waits
        times.append((time.perf_counter() - t0) / sc["timed_steps"] * 1e3)
    return times


def _gan(sc: Dict[str, Any], device: str) -> Dict[str, Any]:
    from sradsgan_tpu_torch.config import load_config
    from sradsgan_tpu_torch.train.trainer import Trainer

    trainer = Trainer(load_config(sc["config"]), device=device)
    load_gan_weights(trainer, sc.get("weights"))
    wrappers = kernel_wrappers()
    out: Dict[str, Any] = {"losses": [], "launches": []}
    for i, batch in enumerate(gan_batches(sc["seed"], sc["steps"],
                                          sc["batch"], sc["lr_size"],
                                          trainer.cfg.scale)):
        for fn in wrappers.values():
            fn.launches = 0
        metrics = trainer.train_step(
            batch, torch.Generator().manual_seed(sc["alpha_seed"]))
        out["losses"].append({k: float(v) for k, v in metrics.items()})
        out["launches"].append({k: fn.launches for k, fn in wrappers.items()})
        if i == 0:
            out["grads"] = {"generator": _grads(trainer.generator),
                            "discriminator": _grads(trainer.discriminator)}
            out["stats"] = {"generator": _stats(trainer.generator),
                            "discriminator": _stats(trainer.discriminator)}
    out["state"] = {"generator": _cpu_state(trainer.generator),
                    "discriminator": _cpu_state(trainer.discriminator)}
    out["graph_stats"] = dict(trainer.graph_stats)
    alphas = torch.Generator().manual_seed(sc["alpha_seed"])
    out["turn_ms"] = _turn_ms(
        lambda: trainer.train_step(batch, alphas)["loss_G"], trainer, sc)
    return out


def _diffusion(sc: Dict[str, Any], device: str) -> Dict[str, Any]:
    from sradsgan_tpu_torch.config import DataConfig
    from sradsgan_tpu_torch.diffusion.trainer import DiffusionTrainer

    with tempfile.TemporaryDirectory() as save_dir:
        trainer = DiffusionTrainer(
            DataConfig(crop_size=sc["crop"], batch_size=sc["batch"]),
            sc["scale"], save_dir=save_dir,
            n_timestep=sc.get("timesteps", 1000),
            unet_kwargs=sc["unet_kwargs"], bf16=False, device=device)
    if sc.get("weights"):
        trainer.unet.load_state_dict(torch.load(
            sc["weights"], map_location=trainer.device, weights_only=True))
    draws = torch.Generator(trainer.device).manual_seed(sc["draw_seed"])
    out: Dict[str, Any] = {"losses": []}
    for i, batch in enumerate(diffusion_batches(sc["seed"], sc["steps"],
                                                sc["batch"], sc["crop"])):
        out["losses"].append(float(trainer.train_step(batch, draws)))
        if i == 0:
            out["grads"] = _grads(trainer.unet)
    out["state"] = _cpu_state(trainer.unet)
    out["turn_ms"] = _turn_ms(lambda: trainer.train_step(batch, draws),
                              trainer, sc)
    return out


def _epoch(sc: Dict[str, Any], device: str) -> Dict[str, Any]:
    from sradsgan_tpu_torch.config import load_config
    from sradsgan_tpu_torch.train.trainer import Trainer

    trainer = Trainer(load_config(sc["config"]), device=device)
    load_gan_weights(trainer, sc.get("weights"))
    val = trainer.train()
    return {"steps": trainer.step, "val": val,
            "state": {"generator": _cpu_state(trainer.generator),
                      "discriminator": _cpu_state(trainer.discriminator)}}


def _validate(sc: Dict[str, Any], device: str) -> Dict[str, Any]:
    from sradsgan_tpu_torch.config import load_config
    from sradsgan_tpu_torch.train.trainer import Trainer

    trainer = Trainer(load_config(sc["config"]), device=device)
    load_gan_weights(trainer, sc.get("weights"))
    return {"val": trainer.validate(sc.get("max_batches"))}


def _tiled_turns(run_one, run_mesh, mesh, turns: List[str]
                 ) -> Dict[str, List[float]]:
    """ms a call (host clock; the scene comes back to the host, which
    waits) of each turn, each begun behind a barrier of every rank: a
    ``"one"`` turn times rank 0 alone (the other ranks wait at the next
    barrier), a ``"mesh"`` turn every rank."""
    times: Dict[str, List[float]] = {"one": [], "mesh": []}
    for turn in turns:
        mesh.barrier()
        if turn == "mesh" or mesh.is_main:
            run = run_mesh if turn == "mesh" else run_one
            t0 = time.perf_counter()
            run()
            times[turn].append((time.perf_counter() - t0) * 1e3)
        mesh.barrier()
    return times


def _tiled(sc: Dict[str, Any], device: str) -> Dict[str, Any]:
    from sradsgan_tpu_torch.evaluation.tiled import tiled_super_resolve
    from sradsgan_tpu_torch.models import create_generator
    from sradsgan_tpu_torch.parallel.mesh import active_mesh

    mesh = active_mesh()
    model = create_generator(sc["model"], sc["scale"],
                             **sc.get("model_kwargs", {}))
    if sc.get("weights"):
        model.load_state_dict(torch.load(sc["weights"], weights_only=True))
    model = model.to(mesh.device).eval()
    image = tiled_scene(sc["seed"], sc["height"], sc["width"])

    def call(on_mesh):
        return tiled_super_resolve(
            model, image, sc["scale"], sc["tile"], sc["halo"],
            sc["batch_tiles"], device=mesh.device,
            mesh=mesh if on_mesh else dataclasses.replace(
                mesh, rank=0, world=1, group=None))

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    scene = call(True)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    turn_ms = _tiled_turns(lambda: call(False), lambda: call(True), mesh,
                           sc.get("turns", []))
    return {"scene": torch.from_numpy(scene), "launches": launches,
            "turn_ms": turn_ms}


SCENARIOS = {"gan": _gan, "diffusion": _diffusion, "epoch": _epoch,
             "validate": _validate, "tiled": _tiled}


def run_rank(rank: int, world: int, init: str, spec: Dict[str, Any],
             out_dir: str) -> None:
    """One rank: join the group, run every scenario, write
    ``rank{rank}.pt``."""
    import torch.distributed as dist

    from sradsgan_tpu_torch.parallel.mesh import create_mesh

    torch.set_num_threads(spec.get("threads", 1))
    # float32 is float32 here: cuDNN would take TF32 for the convs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for tiny in spec.get("tiny", []):
        register_tiny(tiny["model"], tiny["d_kwargs"])
    device = spec["device"]
    create_mesh(-1, device, rank=rank, world=world, init_method=init,
                backend=spec.get("backend"))
    results = {}
    try:
        for sc in spec["scenarios"]:
            results[sc["name"]] = SCENARIOS[sc["kind"]](sc, device)
    finally:
        dist.destroy_process_group()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(spec: Dict[str, Any], world: int, work_dir: str,
              timeout: float) -> List[Dict[str, Any]]:
    """Run ``spec`` on ``world`` ranks, one process each, over a ``file://``
    store in ``work_dir``; each rank's results, rank 0 first.  Raises,
    with the ranks' output, if any rank fails or the deadline passes (the
    ranks are killed then)."""
    os.makedirs(work_dir, exist_ok=True)
    spec_path = os.path.join(work_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    store = os.path.join(work_dir, f"store_{time.time_ns()}")
    env = dict(os.environ, OMP_NUM_THREADS=str(spec.get("threads", 1)),
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    logs = [os.path.join(work_dir, f"rank{r}.log") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "sradsgan_tpu_torch.tools.dp_check",
                     "--rank", str(r), "--world", str(world), "--init",
                     f"file://{store}", "--spec", spec_path, "--out",
                     work_dir], cwd=ROOT, env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"dp_check: the ranks did not finish within "
                           f"{timeout} s\n{_tails(logs)}") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"dp_check: rank exit codes "
                           f"{[p.returncode for p in procs]}\n{_tails(logs)}")
    return [torch.load(os.path.join(work_dir, f"rank{r}.pt"),
                       weights_only=True) for r in range(world)]


def _tails(logs: List[str], lines: int = 30) -> str:
    out = []
    for path in logs:
        with open(path) as f:
            out.append(f"--- {os.path.basename(path)}\n"
                       + "".join(f.readlines()[-lines:]))
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dp_check")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init", required=True)
    p.add_argument("--spec", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    run_rank(args.rank, args.world, args.init, spec, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
