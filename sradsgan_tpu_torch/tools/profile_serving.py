"""Where the time of one serving request goes on the card.

    python -m sradsgan_tpu_torch.tools.profile_serving [--dtype bfloat16]
        [--rab-tail fused] [--batch 8]

Builds the full-width SRADSGAN x4 generator (seeded random weights), warms a
``serving.Predictor`` up on a batch of four 54^2 requests (the request
``chip_smoke.py`` times; ``--batch 8`` is a batch of the evaluation
protocol's sweep), then serves five of them under
``torch.profiler`` and prints the wall time per request, the device's busy
share of that window (the sum of kernel times over the wall time; one
stream, so kernels do not overlap) and the device time by kernel, largest
first.  Needs a CUDA device; float32 runs with TF32 off.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from sradsgan_tpu_torch.models import create_generator
from sradsgan_tpu_torch.serving import Predictor


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="profile_serving")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--rab-tail", choices=["unfused", "fused"],
                   default="unfused")
    p.add_argument("--batch", type=int, default=4)
    args = p.parse_args(argv)
    batch, size, iters = args.batch, 54, 5
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    pred = Predictor(create_generator("sradsgan", 4, seed=0,
                                      rab_tail=args.rab_tail), 4,
                     dtype=getattr(torch, args.dtype))
    x = np.random.default_rng(0).random((batch, size, size, 3),
                                        dtype=np.float32)
    for _ in range(3):
        pred(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            pred(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0
                      and e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda row: -row[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    print(f"{batch} x {size}^2 {args.dtype}, RAB tail {args.rab_tail}: "
          f"{wall_ms / iters:.3f} ms/request wall, device busy "
          f"{busy_ms / iters:.3f} ms/request "
          f"({100 * busy_ms / wall_ms:.1f}% of the window)")
    for name, ms, count in kernels[:20]:
        print(f"{ms / iters:9.4f} ms/request {100 * ms / busy_ms:5.1f}%"
              f"  x{count // iters:<4d} {name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
