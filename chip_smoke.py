#!/usr/bin/env python3
"""Smoke test of the PyTorch port (sradsgan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs 1 GPU

Phases, each of which raises (exit code 1) on failure:

1. device: a CUDA device must be present; prints nvidia-smi's name and
   power limit of device 0;
2. build: compiles the port's CUDA kernels from ``sradsgan_tpu_torch/csrc``
   (one nvcc per source, all at once);
3. kernels: each kernel against its plain PyTorch version on the card at
   the train step's and the serving path's shapes, float32 and bfloat16,
   every output, with its error and its time beside the plain version's
   (CUDA events);
4. serving: the full-width SRADSGAN x4 generator (12 groups x 3 RABs x 64
   filters, seeded random weights, both attention gains 0.5) served by
   ``serving.Predictor``: a batch of four 54^2 requests, a 60x50 and a
   130x130 request (bucket padding) and a 240x240 one (halo tiling).  The
   launch counters must show that every kernel of that path ran.  The
   card's output for two 54^2 images is held against the CPU plain path
   (TF32 off), the bf16 output against the float32 one, and the
   batch-of-four latency is timed in both types;
5. train, correctness: one float32 WGAN-GP step of the full-width x4
   ``train.Trainer`` (generator, CBAM patch discriminator, VGG19 content
   term; seeded fan-in-scaled conv weights, gains 0.5) at batch 2 of
   54^2 -> 216^2 on the card, held against the CPU plain path's step in
   float64 from the same weights, batch and penalty weights: the losses
   must agree, every G and D parameter gradient must stay within a fixed
   bound per network (GRAD_TOL), which the CPU's own float32 step must meet
   too, and the launch counters must show K1-K5 at the counts the module
   structure predicts, the gate backward in the generator and in the
   discriminator (penalty included);
6. train, timing: steps at batch 16 of 54^2 -> 216^2 in float32 (TF32 off)
   and in the mixed precision of ``cfg.bf16``, in ms per step and MP/s of
   HR output; the mixed-precision losses must stay finite.

It prints the kernels' record as one JSON line before the last, and ends
with ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from sradsgan_tpu_torch.evaluation.tiled import forward_numpy
from sradsgan_tpu_torch.models import create_generator
from sradsgan_tpu_torch.ops import _build, pooling, sgam_flash, spatial_gate
from sradsgan_tpu_torch.serving import Predictor
from sradsgan_tpu_torch.tools.profile_train import make_batch, make_trainer

# Kernel tolerances: max |kernel - plain| over max |plain|, per output.
# float32 sums in another order than torch's reductions (a few ulp);
# bfloat16 outputs may round one bf16 ulp (2^-8) apart.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SLICE_TOL = 1e-4  # card vs CPU plain path, float32 with TF32 off
# Train step, the card's float32 step (TF32 off) against the CPU plain path
# in float64 (phase_train_correctness): every gradient tensor within
# GRAD_TOL[network] of its own max |ref|, and the CPU's float32 step, the
# control, within it too; a gradient that is zero by the math
# (zero_by_math) below ZERO_TOL of the network's largest, on the card; the
# losses within LOSS_TOL of max(|ref|, 0.01).  GRAD_TOL is twice the worst
# float32 reading against float64 on an H100 80GB HBM3 (700 W) and its
# host's CPU: card 5.1e-4 (G) and 9.7e-3 (D); CPU float32 on 8 threads
# 5.3e-4 and 9.1e-3, on 1 thread 4.3e-4 and 6.1e-3.  The discriminator's is
# wider because float32 rounding alone moves its conv weights' gradients
# (the penalty's terms cancel) by about 1 % of their largest.
GRAD_TOL = {"generator": 1e-3, "discriminator": 2e-2}
ZERO_TOL = 1e-3
LOSS_TOL = 1e-4

KERNELS = {
    "avg_max_pool": dict(
        cuda=pooling.avg_max_pool_cuda,
        source="sradsgan_tpu_torch/csrc/pooling.cu",
        replaces="sradsgan_tpu/ops/pallas/pooling.py:39"),
    "spatial_gate": dict(
        cuda=spatial_gate.spatial_gate_cuda,
        source="sradsgan_tpu_torch/csrc/spatial_gate.cu",
        replaces="sradsgan_tpu/ops/pallas/slam.py:127"),
    "position_attention": dict(
        cuda=sgam_flash.position_attention_cuda,
        source="sradsgan_tpu_torch/csrc/sgam_flash.cu",
        replaces="sradsgan_tpu/ops/sgam_flash.py:126"),
    "spatial_gate_bwd": dict(
        cuda=spatial_gate.spatial_gate_bwd_cuda,
        source="sradsgan_tpu_torch/csrc/spatial_gate_bwd.cu",
        replaces="sradsgan_tpu/ops/pallas/slam.py:207"),
    "position_attention_bwd": dict(
        cuda=sgam_flash.position_attention_bwd_cuda,
        source="sradsgan_tpu_torch/csrc/sgam_flash_bwd.cu",
        replaces="sradsgan_tpu/ops/sgam_flash.py:126"),
}


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def _event_ms(run, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(device ms, eager ms) per call of fn, by CUDA events.

    Device time replays a CUDA graph of ``iters`` calls, so it counts the
    kernels alone; eager time runs the calls from Python, so it also counts
    the host's launch overhead when that is the slower side."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def eager():
        for _ in range(iters):
            fn()

    eager_ms = _event_ms(eager, iters)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        eager()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, iters), eager_ms


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("no CUDA device is visible; this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.BUILD_DIR / _build.source_hash()})")
    log = _build.BUILD_DIR / _build.source_hash() / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip())


def _randn(shape, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to("cuda", dtype)


def _gate_bwd_kernel(x, w, g):
    """K4 as the step runs it: the kernel, then the dw contraction from its
    planes; returns (dx, dw, mean, max)."""
    dx, ds, mean, mx = spatial_gate.spatial_gate_bwd_cuda(x, w, g)
    return (dx, spatial_gate.dw_contraction(
        ds, torch.stack([mean, mx], dim=1), w), mean, mx)


def _gate_bwd_plain(x, w, g):
    x32 = x.float()
    return (*spatial_gate.spatial_gate_bwd_plain(x, w, g), x32.mean(1),
            x32.amax(1))


def _kernel_cases():
    """(kernel, label, dtype, shape, run kernel, run plain): zero-argument
    calls at the train step's shapes first, then the serving path's."""
    w = _randn((1, 2, 7, 7), torch.float32, 1, scale=0.3)
    for dtype in (torch.float32, torch.bfloat16):
        # the generator's gates, the discriminator's CBAM, a ragged tile
        for shape in ((16, 64, 54, 54), (16, 256, 27, 27), (3, 64, 27, 31)):
            x = _randn(shape, dtype, 2)
            g = _randn(shape, dtype, 6)
            yield ("avg_max_pool", "", dtype, shape,
                   lambda x=x: pooling.avg_max_pool_cuda(x),
                   lambda x=x: pooling.avg_max_pool_plain(x))
            yield ("spatial_gate", "", dtype, shape,
                   lambda x=x: spatial_gate.spatial_gate_cuda(x, w),
                   lambda x=x: spatial_gate.spatial_gate_plain(x, w))
            if shape[0] == 16:
                yield ("spatial_gate_bwd", "", dtype, shape,
                       lambda x=x, g=g: _gate_bwd_kernel(x, w, g),
                       lambda x=x, g=g: _gate_bwd_plain(x, w, g))
        # SGAM at the train step's batch, N = 54^2, then a ragged 27^2 and
        # the serving record's batch of two
        for b, n in ((16, 2916), (16, 729), (2, 2916)):
            q = _randn((b, n, 8), dtype, 3, scale=0.5)
            k = _randn((b, n, 8), dtype, 4, scale=0.5)
            v = _randn((b, n, 64), dtype, 5)
            dout = _randn((b, n, 64), dtype, 7)
            shape = (b, n, 8, 64)
            yield ("position_attention", "", dtype, shape,
                   lambda q=q, k=k, v=v:
                   sgam_flash.position_attention_cuda(q, k, v),
                   lambda q=q, k=k, v=v:
                   sgam_flash.position_attention_plain(q, k, v))
            if b == 2:
                continue
            yield ("position_attention", " +lse", dtype, shape,
                   lambda q=q, k=k, v=v: sgam_flash.position_attention_cuda(
                       q, k, v, with_lse=True)[0],
                   lambda q=q, k=k, v=v:
                   sgam_flash.position_attention_plain(q, k, v))
            out, lse = sgam_flash.position_attention_cuda(q, k, v,
                                                          with_lse=True)
            yield ("position_attention_bwd", "", dtype, shape,
                   lambda q=q, k=k, v=v, out=out, dout=dout, lse=lse:
                   sgam_flash.position_attention_bwd_cuda(q, k, v, out, dout,
                                                          lse),
                   lambda q=q, k=k, v=v, dout=dout:
                   sgam_flash.position_attention_bwd_plain(q, k, v, dout))


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns, per kernel, the
    error and times at its first (train step, float32) case, and the K3
    time with the log-sum-exp store."""
    record = {}
    for name, label, dtype, shape, kernel, plain in _kernel_cases():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs = [float((g.float() - r.float()).abs().max()) for g, r in
                zip(got, want)]
        refs = [float(r.float().abs().max()) for r in want]
        rels = [e / r for e, r in zip(errs, refs)]
        if name == "avg_max_pool" and errs[1] != 0.0:
            fail(f"{name} {dtype} {shape}: max differs by {errs[1]}")
        if not max(rels) <= TOL[dtype]:
            fail(f"{name}{label} {dtype} {shape}: errors {rels} of max|ref| "
                 f"exceed {TOL[dtype]:.0e}")
        # plain, kernel, kernel, plain: drift hits both alike
        p1 = cuda_ms(plain)
        k1 = cuda_ms(kernel)
        k2 = cuda_ms(kernel)
        p2 = cuda_ms(plain)
        ms, eager_ms = ((a + b) / 2 for a, b in zip(k1, k2))
        plain_ms, plain_eager_ms = ((a + b) / 2 for a, b in zip(p1, p2))
        print(f"kernel {name + label:<24} {str(dtype):<14} {str(shape):<18} "
              f"max_abs_err {max(errs):.3e} (of max|ref|: "
              f"{', '.join(f'{r:.2e}' for r in rels)}; tol "
              f"{TOL[dtype]:.0e})  device: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; eager: kernel {eager_ms:.4f} ms, plain "
              f"{plain_eager_ms:.4f} ms")
        if label:
            record[name].setdefault("ms_with_lse", ms)
        elif name not in record:
            record[name] = {"max_abs_err": max(errs), "ms": ms,
                            "plain_ms": plain_ms, "eager_ms": eager_ms,
                            "plain_eager_ms": plain_eager_ms,
                            "dtype": str(dtype), "shape": list(shape)}
    return record


def reset_launches() -> None:
    for spec in KERNELS.values():
        spec["cuda"].launches = 0


def read_launches() -> dict:
    return {name: spec["cuda"].launches for name, spec in KERNELS.items()}


def psnr(x: np.ndarray, ref: np.ndarray) -> float:
    """PSNR of x against ref, peak = ref's peak-to-peak range."""
    mse = float(np.mean((x.astype(np.float64) - ref) ** 2))
    peak = float(ref.max() - ref.min())
    return float("inf") if mse == 0 else 10 * np.log10(peak * peak / mse)


def latency_ms(pred: Predictor, x: np.ndarray, iters: int = 10) -> float:
    """Host-clock request latency; each request ends in a device-to-host
    copy, which waits for the device."""
    for _ in range(2):
        pred(x)
    t0 = time.perf_counter()
    for _ in range(iters):
        pred(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def phase_serving(smi: str) -> dict:
    scale = 4
    model = create_generator("sradsgan", scale, seed=0)
    with torch.no_grad():
        model.GAB_UP.ca.gamma.fill_(0.5)
        model.GAB_UP.sa.gamma.fill_(0.5)
    cpu_model = copy.deepcopy(model).eval()
    n_gates = len(model.res_groups) * (len(model.res_groups[0].RG) + 1)

    rng = np.random.default_rng(0)
    requests = {
        "batch4_54x54": rng.random((4, 54, 54, 3), dtype=np.float32),
        "60x50": rng.random((60, 50, 3), dtype=np.float32),
        "130x130": rng.random((130, 130, 3), dtype=np.float32),
        "240x240_tiled": rng.random((240, 240, 3), dtype=np.float32),
    }
    pred = Predictor(model, scale)  # device="cuda", float32

    reset_launches()
    outs = {name: pred(x) for name, x in requests.items()}
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"serving path launches: {launches}")
    forwards = 4  # one per request; the 25 tiles of 240x240 fit one call
    expected = {"avg_max_pool": forwards * n_gates,
                "spatial_gate": forwards * n_gates,
                "position_attention": forwards, "spatial_gate_bwd": 0,
                "position_attention_bwd": 0}
    if launches != expected:
        fail(f"launch counts {launches} differ from the path's {expected}")

    for name, x in requests.items():
        want = tuple(x.shape[:-3]) + (x.shape[-3] * scale,
                                      x.shape[-2] * scale, 3)
        out = outs[name]
        if out.shape != want or not np.isfinite(out).all():
            fail(f"request {name}: output {out.shape} (want {want}), "
                 f"finite={np.isfinite(out).all()}")
        print(f"request {name:<14} -> {out.shape}, finite, "
              f"max|y| {np.abs(out).max():.4e}")

    pair = requests["batch4_54x54"][:2]
    t0 = time.perf_counter()
    ref = forward_numpy(cpu_model, pair, "cpu")
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(pred(pair) - ref).max())
    bound = SLICE_TOL * float(np.abs(ref).max())
    print(f"slice vs CPU plain path (2 x 54^2, TF32 off): max|d| {err:.3e} "
          f"<= {bound:.3e} ({SLICE_TOL:.0e} * max|ref|); CPU took "
          f"{cpu_s:.1f} s")
    if not err <= bound:
        fail("the card's output disagrees with the CPU plain path")

    pred_bf16 = Predictor(model, scale, dtype=torch.bfloat16)
    batch = requests["batch4_54x54"]
    out_bf16 = pred_bf16(batch)
    if not np.isfinite(out_bf16).all():
        fail("bf16 output is not finite")
    db = psnr(out_bf16, outs["batch4_54x54"])
    print(f"bf16 vs f32 on the batch of four: PSNR {db:.2f} dB "
          "(peak = the f32 output's range)")

    mpix = batch.shape[0] * (54 * scale) ** 2 / 1e6
    serving = {"psnr_bf16_vs_f32_db": db}
    for label, p in (("f32", pred), ("bf16", pred_bf16)):
        ms = latency_ms(p, batch)
        serving[f"{label}_ms"] = ms
        serving[f"{label}_mp_per_s"] = mpix / (ms / 1e3)
        print(f"serving batch 4 x 54^2 -> 216^2 {label}: {ms:.2f} ms/request, "
              f"{mpix / (ms / 1e3):.3f} MP/s of output [{smi}]")
    return {"launches": launches, "serving": serving}


def step_launches(trainer) -> dict:
    """Kernel launches one train step makes, from the module structure: a
    pool (K1) and a gate (K2) in each of the generator's local attentions
    and in the discriminator's CBAM, for each of the step's four D forwards
    (sr in the G step, hr, sr.detach() and the interpolates); K3 and K5 once
    for the SGAM.  The gate backward (K4) runs once per gate of the
    generator's backward and five times in the discriminator: the backward
    through D(sr) in the G step, the penalty's gradient (the inner
    backward), and in the D step's backward through D(hr), D(sr.detach())
    and, from the penalty's second order reaching the gate's output through
    the BatchNorms after it, D(interpolates)."""
    g = trainer.generator
    n_gates = len(g.res_groups) * (len(g.res_groups[0].RG) + 1)
    d_forwards = 4
    return {"avg_max_pool": n_gates + d_forwards,
            "spatial_gate": n_gates + d_forwards,
            "position_attention": 1,
            "spatial_gate_bwd": n_gates + 5,
            "position_attention_bwd": 1}


def fan_in_init(model: torch.nn.Module, seed: int) -> None:
    """Conv kernels normal(0, 0.5 / sqrt(fan_in)) and biases normal(0, 0.05),
    drawn on the CPU, as the CPU tests draw them: activations of order one
    through all 36 RABs.  At the JAX init (std 0.02) the deep gates see
    vanishing signals and their gradients are sums that cancel: a CPU
    float32 step then differs from the float64 one by 1.7e-2 (8 threads)
    to 3.3e-2 (1 thread) of a tensor's largest, so no fixed bound could
    tell a kernel fault from float32 rounding there."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                w = torch.randn(m.weight.shape, generator=gen)
                m.weight.copy_(w * 0.5 / m.weight[0].numel() ** 0.5)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=gen)
                                 * 0.05)


def _max_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double().cpu()
    return float((got.double().cpu() - ref).abs().max() / ref.abs().max())


def zero_by_math(model: torch.nn.Module) -> set:
    """Parameters whose gradient is exactly zero in exact arithmetic: the
    bias of a conv that feeds a BatchNorm (the normalization removes any
    per-channel shift) and the SGAM key conv's bias (it shifts each query's
    energies by a constant, which the softmax removes)."""
    names = {n for n, _ in model.named_parameters()
             if n.endswith("sa.key_conv.bias")}
    layers = list(model.named_modules())
    for (name, m), (_, nxt) in zip(layers, layers[1:]):
        if (isinstance(m, torch.nn.Conv2d) and m.bias is not None
                and isinstance(nxt, torch.nn.BatchNorm2d)):
            names.add(f"{name}.bias")
    return names


def _fan_in_trainer(device: str, float64: bool = False):
    trainer = make_trainer("f32", device=device)
    for net in (trainer.generator, trainer.discriminator):
        fan_in_init(net, seed=3)
    if float64:
        for net in (trainer.generator, trainer.discriminator, trainer.vgg):
            net.double()
    return trainer


def _grad_errors(got, ref, skip) -> list:
    """[(max |got - ref| over max |ref|, name)] per parameter, worst first."""
    mine = dict(got.named_parameters())
    return sorted(((_max_rel(mine[n].grad, p.grad), n)
                   for n, p in ref.named_parameters() if n not in skip),
                  reverse=True)


def _cpu_step(batch, float64: bool):
    trainer = _fan_in_trainer("cpu", float64)
    t0 = time.perf_counter()
    metrics = trainer.train_step(batch, torch.Generator().manual_seed(7))
    return trainer, metrics, time.perf_counter() - t0


def phase_train_correctness() -> dict:
    """One float32 step on the card against the CPU plain path's step in
    float64, from the same weights, batch and penalty weights; returns the
    step's launch counts and the gradient report.

    The step's gradients are ill-conditioned in places (sums that cancel,
    BatchNorm over the penalty's second order), so float32 rounding alone
    moves some of them by parts in 10^3 of their tensor's largest.  The
    reference is therefore float64, and the CPU's own float32 step is the
    control: it must pass the same fixed bound, or the bound says nothing
    about the card."""
    batch = make_batch(batch=2, seed=1)
    card = _fan_in_trainer("cuda")
    reset_launches()
    got = card.train_step(batch, torch.Generator().manual_seed(7))
    torch.cuda.synchronize()
    launches = read_launches()
    want_launches = step_launches(card)
    print(f"train step launches (batch 2, f32): {launches}")
    if launches != want_launches:
        fail(f"train step launch counts {launches} differ from the "
             f"module structure's {want_launches}")

    ref, want, ref_s = _cpu_step(batch, float64=True)
    control, control_metrics, control_s = _cpu_step(batch, float64=False)
    for key in ("loss_G", "loss_D", "pixel", "content", "adv_g"):
        w = float(want[key])
        for side, metrics in (("card", got), ("CPU float32", control_metrics)):
            g = float(metrics[key])
            if not abs(g - w) <= LOSS_TOL * max(abs(w), 1e-2):
                fail(f"train step {key}: {side} {g!r} vs CPU float64 {w!r}")
    print("train step losses, card / CPU float32 / CPU float64: "
          + ", ".join(f"{k} {float(got[k]):.8e} / "
                      f"{float(control_metrics[k]):.8e} / {float(want[k]):.8e}"
                      for k in ("loss_G", "loss_D")))
    report, faults = {}, []
    for net in ("generator", "discriminator"):
        model, reference = getattr(card, net), getattr(ref, net)
        scale = max(float(p.grad.abs().max()) for p in reference.parameters())
        zero = zero_by_math(model)
        zero_worst = max(float(p.grad.abs().max()) / scale
                         for n, p in model.named_parameters() if n in zero)
        errs = _grad_errors(model, reference, zero)
        ctrl = _grad_errors(getattr(control, net), reference, zero)
        tol = GRAD_TOL[net]
        report[net] = {"worst": errs[0][1], "err": errs[0][0],
                       "control_worst": ctrl[0][1], "control_err": ctrl[0][0],
                       "tol": tol, "zero_by_math_worst": zero_worst,
                       "tensors": len(errs)}
        print(f"train step {net} gradients against the CPU float64 step: "
              f"{len(errs)} tensors; card worst of max|ref|: "
              + ", ".join(f"{n} {e:.3e}" for e, n in errs[:4])
              + "; CPU float32 (control) worst: "
              + ", ".join(f"{n} {e:.3e}" for e, n in ctrl[:2])
              + f"; tol {tol:.0e}; {len(zero)} zero by the math, card's "
              f"largest {zero_worst:.3e} of the network's largest "
              f"(tol {ZERO_TOL:.0e})")
        if not errs[0][0] <= tol:
            faults.append(f"{net} gradient {errs[0][1]} differs from float64 "
                          f"by {errs[0][0]:.3e} of max|ref|, over {tol:.0e}")
        if not ctrl[0][0] <= tol:
            faults.append(f"the CPU's float32 {net} gradient {ctrl[0][1]} "
                          f"differs from float64 by {ctrl[0][0]:.3e}, over "
                          f"{tol:.0e}: the bound no longer tells a fault "
                          "from float32 rounding")
        if not zero_worst <= ZERO_TOL:
            faults.append(f"a {net} gradient that is zero by the math "
                          f"reaches {zero_worst:.3e} of the largest")
    for key in ("GAB_UP.sa.query_conv.weight", "GAB_UP.sa.gamma"):
        if not float(card.generator.get_parameter(key).grad.abs().max()) > 0:
            faults.append(f"the SGAM gradient {key} is zero")
    print(f"CPU steps took {ref_s:.1f} s (float64) and {control_s:.1f} s "
          "(float32)")
    if faults:
        fail("; ".join(faults))
    return {"launches": launches, "grad_check": report}


def phase_train_timing(smi: str) -> dict:
    """ms per step and MP/s of HR output at batch 16, float32 and mixed
    precision; returns the timings and the first f32 step's launches."""
    batch = make_batch()
    mpix = 16 * 216 * 216 / 1e6
    out = {}
    for precision in ("f32", "bf16"):
        trainer = make_trainer(precision)
        reset_launches()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != step_launches(trainer):
            fail(f"{precision} train step launches {launches} differ from "
                 f"{step_launches(trainer)}")
        out[f"launches_{precision}"] = launches
        trainer.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = 5
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = trainer.train_step(batch)
        losses = {k: float(v) for k, v in metrics.items()}  # waits
        ms = (time.perf_counter() - t0) / steps * 1e3
        if not np.isfinite(list(losses.values())).all():
            fail(f"{precision} train step losses are not finite: {losses}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[f"{precision}_ms_per_step"] = ms
        out[f"{precision}_mp_per_s"] = mpix / (ms / 1e3)
        out[f"{precision}_peak_gib"] = peak
        print(f"train step batch 16 x 54^2 -> 216^2 {precision}: "
              f"{ms:.2f} ms/step, {mpix / (ms / 1e3):.3f} MP/s of HR output, "
              f"peak {peak:.2f} GiB; losses {losses} [{smi}]")
        del trainer
    return out


def main() -> int:
    # Full float32 in the plain versions too: cuDNN would run the float32
    # convs in TF32 (about three decimal digits) by default.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_device()
    phase_build()
    record = phase_kernels()
    serving = phase_serving(smi)
    correctness = phase_train_correctness()
    timing = phase_train_timing(smi)
    kernels = [{"name": name, "route": "cuda", "source": spec["source"],
                "replaces": spec["replaces"],
                "launches": timing["launches_f32"][name],
                "launches_by_path": {
                    "serving": serving["launches"][name],
                    "train_f32": timing["launches_f32"][name],
                    "train_bf16": timing["launches_bf16"][name]},
                **record[name]}
               for name, spec in KERNELS.items()]
    print(json.dumps({"kernels": kernels, "serving": serving["serving"],
                      "train": {k: v for k, v in timing.items()
                                if not k.startswith("launches")},
                      "train_grad_check": correctness["grad_check"],
                      "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
