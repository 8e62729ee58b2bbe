"""The batch-4 serving request's latency, the f32 train step's and the
host's cost of an eager gate-forward call, for comparing two trees of the
repo on one machine.

    python -m sradsgan_tpu_torch.tools.request_probe LABEL

Run it from the root of each tree in turn (parent, change, change, parent):
the kernels are built from that tree's ``csrc/``; a tree whose copy of this
file is older takes this one (it needs only ``Predictor``,
``spatial_gate`` and ``tools/profile_train.py``).  Prints one line:

- the host time of 200 back-to-back ``spatial_gate_cuda`` calls at
  (16, 64, 54, 54) float32 with the card idle, per call, and of 200 calls
  of ``spatial_gate.spatial_gate``, the entry the generator calls (under
  no-grad), which adds the dispatch to the kernel (in a tree with the
  registered ops, the op's dispatcher);
- the host time of 20 calls at (4, 64, 54, 54) queued behind a sleep
  kernel of about 50 ms, three times: a launch that made the host wait for
  the device would take about the sleep's length here;
- the full-width x4 generator (seeded weights, both GAB_UP gammas 0.5)
  behind ``serving.Predictor``, a batch of four 54^2 images in float32,
  unfused, TF32 off: five readings of the mean over ten requests after
  three warm-up ones, and their median;
- the full-width x4 WGAN-GP train step (``profile_train.make_trainer``)
  at batch 16 in float32, unfused, TF32 off: three readings of the mean
  over three steps after two warm-up ones, and their median.

The request is host-bound, so its readings move with the host's load:
compare trees only on one machine at one time, in alternating order.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sradsgan_tpu_torch.models import create_generator
from sradsgan_tpu_torch.ops import spatial_gate
from sradsgan_tpu_torch.serving import Predictor


def _gate_inputs(shape):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(shape, generator=g).cuda()
    w = (torch.randn((1, 2, 7, 7), generator=g) * 0.3).cuda()
    return x, w


def enqueue_idle_us(calls: int = 200, fn=None) -> float:
    """Host microseconds a call of ``fn`` (the kernel's wrapper by
    default), the card idle at the start."""
    fn = fn or spatial_gate.spatial_gate_cuda
    x, w = _gate_inputs((16, 64, 54, 54))
    with torch.no_grad():
        for _ in range(10):
            fn(x, w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(x, w)
        us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def enqueue_behind_sleep_ms(calls: int = 20, cycles: int = 100_000_000):
    """Host ms of ``calls`` calls queued behind a sleep kernel (three
    readings), and the sleep kernel's own length."""
    x, w = _gate_inputs((4, 64, 54, 54))
    for _ in range(10):
        spatial_gate.spatial_gate_cuda(x, w)
    torch.cuda.synchronize()
    readings = []
    for _ in range(3):
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        for _ in range(calls):
            spatial_gate.spatial_gate_cuda(x, w)
        readings.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    return readings, (time.perf_counter() - t0) * 1e3


def request_ms(readings: int = 5, per_reading: int = 10) -> list:
    model = create_generator("sradsgan", 4, seed=0)
    with torch.no_grad():
        model.GAB_UP.ca.gamma.fill_(0.5)
        model.GAB_UP.sa.gamma.fill_(0.5)
    pred = Predictor(model, 4)
    x = np.random.default_rng(0).random((4, 54, 54, 3), dtype=np.float32)
    for _ in range(3):
        pred(x)
    torch.cuda.synchronize()
    out = []
    for _ in range(readings):
        t0 = time.perf_counter()
        for _ in range(per_reading):
            pred(x)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / per_reading * 1e3)
    return out


def step_ms(readings: int = 3, per_reading: int = 3) -> list:
    from sradsgan_tpu_torch.tools.profile_train import (make_batch,
                                                        make_trainer)

    trainer = make_trainer("f32")
    batch = make_batch()
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    out = []
    for _ in range(readings):
        t0 = time.perf_counter()
        for _ in range(per_reading):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / per_reading * 1e3)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="request_probe")
    p.add_argument("label", help="names the tree in the printed line")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("request_probe needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    idle = enqueue_idle_us()
    entry = enqueue_idle_us(fn=spatial_gate.spatial_gate)
    behind, sleep_ms = enqueue_behind_sleep_ms()
    lat = request_ms()
    step = step_ms()
    print(f"{args.label}: K2 host enqueue {idle:.1f} us a call idle, "
          f"{entry:.1f} us through spatial_gate.spatial_gate; 20 K2 "
          f"calls enqueued behind a {sleep_ms:.1f} ms sleep kernel in "
          f"{[round(v, 2) for v in behind]} ms of host time; request batch 4 "
          f"f32 unfused ms {[round(v, 3) for v in lat]} median "
          f"{sorted(lat)[len(lat) // 2]:.3f}; step batch 16 f32 unfused ms "
          f"{[round(v, 2) for v in step]} median "
          f"{sorted(step)[len(step) // 2]:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
