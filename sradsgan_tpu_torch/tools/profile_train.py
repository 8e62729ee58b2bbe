"""Where the time of one train step goes on the card.

    python -m sradsgan_tpu_torch.tools.profile_train [--precision bf16]
        [--rab-tail fused] [--model sragan]

Builds the full-width SRADSGAN x4 WGAN-GP trainer (12 groups x 3 RABs x 64
filters, the CBAM patch discriminator, the VGG19 content term; seeded random
weights, both attention gains 0.5), or that of another GAN model of the
registry with ``--model``, takes three warm-up steps at batch 16 of
54^2 -> 216^2, then profiles ``--steps`` more under ``torch.profiler`` and
prints the wall time per step, the device's busy share of that window (the
sum of kernel times over the wall time; one stream, so kernels do not
overlap) and the device time by kernel, largest first.  ``--precision f32``
runs float32 with TF32 off (the parity mode); ``bf16`` the mixed precision
of ``cfg.bf16`` and ``cfg.d_bf16``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from sradsgan_tpu_torch.models import config_for_model, get_spec
from sradsgan_tpu_torch.train.trainer import Trainer

BATCH, LR_SIZE, SCALE = 16, 54, 4


def make_trainer(precision: str, device: str = "cuda",
                 rab_tail: str = "unfused", model: str = "sradsgan",
                 **model_kwargs) -> Trainer:
    """The x4 trainer of ``model`` (the flagship by default), seed 0, its
    global attention gains 0.5; ``rab_tail`` reaches the generators that
    take it (those with CA-SA tails: SRADSGAN, SRAGAN), ``model_kwargs``
    the generator.
    Weights depend on the seed alone, not on the device or the RAB tail's
    formulation."""
    bf16 = precision == "bf16"
    if "rab_tail" in inspect.signature(get_spec(model).generator).parameters:
        model_kwargs["rab_tail"] = rab_tail
    cfg = config_for_model(model, SCALE, bf16=bf16, d_bf16=bf16,
                           model_kwargs=model_kwargs)
    trainer = Trainer(cfg, device=device)
    with torch.no_grad():
        for name, p in trainer.generator.named_parameters():
            if name.endswith(("ca.gamma", "sa.gamma")):
                p.fill_(0.5)
    return trainer


def make_batch(batch: int = BATCH, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    hr = LR_SIZE * SCALE
    return {"lr": rng.random((batch, LR_SIZE, LR_SIZE, 3), dtype=np.float32),
            "hr": rng.random((batch, hr, hr, 3), dtype=np.float32)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="profile_train")
    p.add_argument("--precision", choices=["f32", "bf16"], default="f32")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--rab-tail", choices=["unfused", "fused"],
                   default="unfused")
    p.add_argument("--model", default="sradsgan",
                   help="a GAN model of the registry (sradsgan, sragan, ...)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    trainer = make_trainer(args.precision, rab_tail=args.rab_tail,
                           model=args.model)
    batch = make_batch()
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0
                      and e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda row: -row[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    n = args.steps
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"{args.model} train step {BATCH} x {LR_SIZE}^2 -> "
          f"{LR_SIZE * SCALE}^2 {args.precision}, RAB tail {args.rab_tail}: "
          f"{wall_ms / n:.3f} "
          f"ms/step wall, device busy {busy_ms / n:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}% of "
          f"the window) [{card}]")
    for name, ms, count in kernels[:25]:
        print(f"{ms / n:9.3f} ms/step {100 * ms / busy_ms:5.1f}%"
              f"  x{count // n:<5d} {name[:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
