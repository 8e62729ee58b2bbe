"""The training cells: back-to-back ``Trainer`` steps fed by the program's
``DataLoader`` and ``device_prefetch`` on one card, WGAN-GP or pixel-only
by the configuration's recipe (``harness.RECIPES``).

Set-up builds one trainer, loads the benchmark's weights into it, and
drives it through the checked steps with the window's own call and feed;
the same trainer then runs the window.  The check compares those steps
with the reference once the window has closed and the program's state is
freed.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from typing import Callable, Dict, List, Mapping, Optional

import torch
from torch.profiler import record_function

from port_bench import compare, flops, trace
from port_bench.harness import Cell, adversarial, build_generator
from port_bench.reference.models import EXACT, Numerics, build
from port_bench.reference.step import follow
from port_bench.traffic import TripletSet, training_set
from port_bench.weights import make_weights, sub_seed


def reference_weights(config: Mapping, seed: int, device) -> Dict:
    """The run's weights of G, and for WGAN-GP of D and VGG19, made on the
    reference's networks."""
    weights = {"g": make_weights(build_generator(config, device), seed,
                                 "generator")}
    if adversarial(config):
        weights.update(
            d=make_weights(build("discriminator", device), seed,
                           "discriminator"),
            vgg=make_weights(build("vgg", device), seed, "vgg",
                             fan_in_std=True))
    return weights


def trained(trainer) -> Dict:
    """The program's trained networks with their optimizers by key: "g",
    and "d" where the trainer has a D."""
    return {key: (net, opt) for key, net, opt in (
        ("g", trainer.generator, trainer.g_opt),
        ("d", trainer.discriminator, trainer.d_opt)) if net is not None}


def program_trainer(config: Mapping, traffic: Mapping, weights: Mapping,
                    device, save_dir: str):
    """The program's trainer as the configuration states it, holding the
    benchmark's weights."""
    from sradsgan_tpu_torch.models import config_for_model, get_spec
    from sradsgan_tpu_torch.train.trainer import Trainer

    r = config["recipe"]
    spec = get_spec(config["model"])
    if spec.pixel_loss != r["pixel"]:
        raise ValueError("the program's pixel loss is not the "
                         "configuration's")
    gan = adversarial(config)
    if spec.adversarial != gan:
        raise ValueError(f"the program trains {config['model']} "
                         f"{'with' if spec.adversarial else 'without'} a D; "
                         f"the configuration's recipe is "
                         f"{r.get('gan', 'none')!r}")
    overrides = {}
    if gan:
        overrides = {
            "gan.gan_type": "wgan-gp", "gan.lambda_gp": r["lambda_gp"],
            "gan.gp_inner_backward": r["penalty_weight"] == "lambda + 1",
            "gan.clip_value": r["clip"], "gan.weight_pixel": r["weight_pixel"],
            "gan.weight_content": r["weight_content"],
            "gan.weight_gan": r["weight_gan"]}
    cfg = config_for_model(
        config["model"], config["scale"],
        bf16=config["precision"]["train_bf16"],
        d_bf16=config["precision"]["train_bf16"],
        save_dir=save_dir,
        model_kwargs=dict(config["widths"]),
        **overrides,
        **{"optim.lr": r["lr"],
           "optim.b1": r["betas"][0], "optim.b2": r["betas"][1],
           "data.batch_size": traffic["batch"],
           "data.crop_size": traffic["lr_size"] * config["scale"],
           "data.num_workers": traffic["workers"]})
    trainer = Trainer(cfg, device=device)
    for key, (net, _) in trained(trainer).items():
        net.load_state_dict(weights[key])
    if trainer.vgg is not None:
        trainer.vgg.load_state_dict(weights["vgg"])
    return trainer


class Feed:
    """The program's loader and prefetcher over the set, a new shuffled
    pass whenever one ends."""

    def __init__(self, data: TripletSet, batch: int, workers: int,
                 seed: int, device):
        from sradsgan_tpu_torch.data.loader import DataLoader

        self.loader = DataLoader(data, batch, shuffle=True, drop_last=True,
                                 num_workers=workers, seed=seed)
        self.device = device
        self.it = None

    def next(self) -> Dict:
        from sradsgan_tpu_torch.data.loader import device_prefetch

        with record_function("bench.feed_wait"):
            while True:
                if self.it is None:
                    self.it = device_prefetch(iter(self.loader), self.device)
                batch = next(self.it, None)
                if batch is not None:
                    return batch
                self.it = None

    def close(self) -> None:
        if self.it is not None:
            self.it.close()
            self.it = None


def _grad_norms(trainer) -> Dict[str, Dict[str, float]]:
    """Each trained leaf's first gradient as Adam holds it after one step:
    exp_avg / (1 - beta1)."""
    out = {}
    for key, (net, opt) in trained(trainer).items():
        b1 = opt.param_groups[0]["betas"][0]
        out[key] = {n: float(opt.state[p]["exp_avg"].norm()) / (1 - b1)
                    for n, p in net.named_parameters() if p in opt.state}
    return out


def _change_norms(trainer, weights) -> Dict[str, Dict[str, float]]:
    return {key: {n: float((p.detach() - weights[key][n]).norm())
                  for n, p in net.named_parameters()}
            for key, (net, _) in trained(trainer).items()}


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        save_dir: str, step_hook: Optional[Callable] = None) -> Dict:
    """One run of a training cell: what it measured and what the check
    read.  ``step_hook`` wraps the step the window calls (a test plants
    faults through it)."""
    config, mix = cell.config, cell.traffic
    weights = reference_weights(config, seed, device)
    trainer = program_trainer(config, mix, weights, device, save_dir)
    data = training_set(mix, config["scale"], seed, device)
    feed = Feed(data, mix["batch"], mix["workers"],
                sub_seed(seed, "data") % 2 ** 31, device)
    alpha_seed = sub_seed(seed, "alpha")
    alpha_gen = torch.Generator().manual_seed(alpha_seed)

    def step(batch):
        return trainer.train_step(batch, alpha_gen)
    if step_hook is not None:
        step = step_hook(trainer, step)

    # the checked steps: the window's own call and feed, first in set-up
    program: Dict = {"losses": []}
    inputs = []
    for i in range(mix["checked_steps"]):
        batch = feed.next()
        inputs.append((batch["lr"].float().cpu(),
                       batch["hr"].float().cpu()))
        out = step(batch)
        program["losses"].append({k: float(out[k])
                                  for k in compare.loss_keys(config)})
        if i == 0:
            program["grad_norms"] = _grad_norms(trainer)
            program["change1_norms"] = _change_norms(trainer, weights)
    program["change_norms"] = _change_norms(trainer, weights)
    _sync(device)
    setup_done = time.perf_counter()

    # the window
    steps, waited, stepping = 0, 0.0, 0.0
    t0 = time.perf_counter()
    out = None
    while time.perf_counter() - t0 < seconds:
        w0 = time.perf_counter()
        batch = feed.next()
        w1 = time.perf_counter()
        with record_function("bench.step"):
            out = step(batch)
        stepping += time.perf_counter() - w1
        waited += w1 - w0
        steps += 1
    if out is not None:
        float(out["loss_G"])
    _sync(device)
    window_s = time.perf_counter() - t0

    print(f"window {window_s:.4f} s: {steps} steps, {waited:.4f} s on the "
          f"feed, {stepping:.4f} s launching steps", file=sys.stderr)
    measured = {"steps": steps, "window_s": window_s, "feed_wait_s": waited,
                "setup_done": setup_done,
                "mpix_s": steps * mix["batch"]
                * (mix["lr_size"] * config["scale"]) ** 2 / 1e6 / window_s}
    if traced:
        def segment():
            for _ in range(mix["traced_steps"]):
                b = feed.next()
                with record_function("bench.step"):
                    o = step(b)
            float(o["loss_G"])
        tr = trace.run_traced(segment, save_dir)
        measured["trace"] = tr
        measured["traced_steps"] = mix["traced_steps"]
        measured["busy_s"] = trace.busy_s(tr)
        measured["flops_per_step"] = flops.train_step_flops(
            config, mix["batch"], mix["lr_size"])
    feed.close()
    measured["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated(device))
        if torch.device(device).type == "cuda" else 0)
    trainer.logger.close()
    del trainer, feed, data, out, step
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    measured["check_inputs"] = {"weights": weights, "inputs": inputs,
                                "alpha_seed": alpha_seed,
                                "program": program}
    # the work of a step for the kernels' roofline: the calls of the
    # check's first reference step
    measured["schedule"] = []
    ref = reference(config, measured["check_inputs"], mix["batch"], device,
                    schedule=measured["schedule"])
    measured["readings"] = compare.train_readings(program, ref, config)
    print(f"readings {json.dumps(measured['readings'])}\n"
          f"worst leaves {compare.worst_leaves(program, ref, config)}",
          file=sys.stderr)
    return measured


def reference_alphas(alpha_seed: int, batch: int, steps: int) -> List:
    """The penalty's weights as the program draws them for the global
    batch, step after step, from the benchmark's generator."""
    gen = torch.Generator().manual_seed(alpha_seed)
    return [torch.rand((batch, 1, 1, 1), generator=gen)
            for _ in range(steps)]


def reference(config, check_inputs: Mapping, batch: int, device,
              numerics: Numerics = EXACT, rows=slice(None),
              g_grads: Optional[Callable] = None,
              schedule: Optional[List] = None) -> Dict:
    """The reference over the checked steps, with the program's inputs;
    ``rows`` of each batch and ``g_grads``, a change to the G's gradients
    before its update, plant a fault in it; ``schedule`` receives the first
    step's calls of the six functions."""
    steps = len(check_inputs["inputs"])
    alphas = ([a[rows] for a in reference_alphas(check_inputs["alpha_seed"],
                                                 batch, steps)]
              if adversarial(config) else [None] * steps)
    return follow(config, check_inputs["weights"],
                  [(lr[rows], hr[rows]) for lr, hr in check_inputs["inputs"]],
                  alphas, device, numerics, g_grads, schedule)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
