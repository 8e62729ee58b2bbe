"""Where the time of GDP diffusion goes on the card.

    python -m sradsgan_tpu_torch.tools.profile_diffusion [--what sample]
        [--precision bf16] [--cudnn-benchmark]

Builds the UNet of the shipped config ``gdp_train_54_216`` (inner 64, mults
(1, 2, 4, 8), attention at downsample rate 8; seeded weights), warms up,
then profiles under ``torch.profiler`` either five denoising steps of one
216^2 image (``--what sample``, ``gaussian.p_sample_step``: the reverse
chain's unit) or three of ``DiffusionTrainer``'s steps at batch 4 of 216^2
(``--what step``), and prints the wall time per step, the device's busy
share of that window (the sum of kernel times over the wall time; above
100 % where kernels overlap) and the device time by kernel, largest first.
``--precision bf16`` runs the UNet under bf16 autocast;
``--cudnn-benchmark`` lets cuDNN time its algorithms.  Needs a CUDA device;
float32 runs with TF32 off.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from sradsgan_tpu_torch.config import DataConfig
from sradsgan_tpu_torch.diffusion.config import (load_gdp_config,
                                                 trainer_kwargs_from_config)
from sradsgan_tpu_torch.diffusion.gaussian import p_sample_step
from sradsgan_tpu_torch.diffusion.trainer import DiffusionTrainer

CONFIG = "gdp_train_54_216"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="profile_diffusion")
    p.add_argument("--what", choices=["sample", "step"], default="sample")
    p.add_argument("--precision", choices=["f32", "bf16"], default="f32")
    p.add_argument("--cudnn-benchmark", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_diffusion needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = args.cudnn_benchmark

    kwargs = trainer_kwargs_from_config(load_gdp_config(CONFIG))
    data_cfg = DataConfig(synthetic=True, crop_size=216, test_crop_size=216,
                          batch_size=4)
    trainer = DiffusionTrainer(data_cfg, kwargs.pop("scale"),
                               save_dir="Result/profile_diffusion",
                               bf16=args.precision == "bf16", device="cuda",
                               **kwargs)
    rng = np.random.default_rng(0)
    batch = 4 if args.what == "step" else 1

    def draw(*shape):
        return torch.from_numpy(rng.uniform(-1, 1, shape).astype(
            np.float32)).cuda()

    if args.what == "step":
        data = {"HR": draw(4, 3, 216, 216), "SR": draw(4, 3, 216, 216)}
        gen = torch.Generator("cuda").manual_seed(1)

        def run():
            trainer.train_step(data, gen)
        iters = 3
    else:
        trainer.unet.eval()
        img, cond, noise = (draw(1, 3, 216, 216) for _ in range(3))

        @torch.no_grad()
        def run():
            p_sample_step(trainer.denoise, trainer.sched, img, cond, 500,
                          noise)
        iters = 5
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: the optimizer's annotation ("Optimizer.step#Adam.step")
    # carries the device time of the kernels inside it again
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0
                      and e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.key.startswith("Optimizer.")),
                     key=lambda row: -row[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    launches = sum(count for _, _, count in kernels)
    print(f"{args.what} {batch} x 216^2 {args.precision}, cudnn.benchmark "
          f"{args.cudnn_benchmark}: {wall_ms / iters:.3f} ms/step wall, "
          f"device busy {busy_ms / iters:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}% of the window), "
          f"{launches // iters} kernels a step")
    for name, ms, count in kernels[:15]:
        print(f"{ms / iters:9.4f} ms/step {100 * ms / busy_ms:5.1f}%"
              f"  x{count // iters:<4d} {name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
