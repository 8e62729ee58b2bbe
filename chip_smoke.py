#!/usr/bin/env python3
"""Smoke test of the PyTorch port (sradsgan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs 1 GPU

Phases, each of which raises (exit code 1) on failure:

1. device: a CUDA device must be present; prints nvidia-smi's name and
   power limit of device 0;
2. build: compiles the port's CUDA kernels from ``sradsgan_tpu_torch/csrc``
   (one nvcc per source, all at once), counts the tensor-core and
   asynchronous-copy instructions of the attention kernels and the fused
   RAB tail, and prints the launches the three row-strip kernels take at
   the main path's shapes (rows or strips an image of each launch, shared
   bytes);
3. kernels: each kernel against its plain PyTorch version on the card at
   the train step's and the serving path's shapes, float32 and bfloat16,
   every output (the gate forward also at the serving request's batch of
   four, one 54^2 and one 216^2 image, two calls bit-equal), with its
   error and its time beside the plain version's
   (CUDA events), beside its bound (the least time the card could take:
   the bytes the function must move over the memory rate, its operations
   over the peak rate of their type, or its exponentials over the special
   function units' rate, whichever is largest) and, where one PyTorch call
   computes the same function, that call's time in float32 and bfloat16;
   the gate backward also without its dw stage and beside the plain dw
   contraction that stage replaced; the fused RAB tail also beside the
   unfused composition it replaces, cold as a ratio; the
   attention forward also at one 216^2 image (N = 46 656) against the plain
   version taken in blocks of queries;
4. serving: the full-width SRADSGAN x4 generator (12 groups x 3 RABs x 64
   filters, seeded random weights, both attention gains 0.5) served by
   ``serving.Predictor``: a batch of four 54^2 requests, a 60x50 and a
   130x130 request (the 216^2 bucket) and a 240x240 one (halo tiling).  The
   launch counters must show that every kernel of that path ran.  The
   card's output for two 54^2 images is held against the CPU plain path
   (TF32 off), the bf16 output against the float32 one, and the
   batch-of-four and the 130x130 latencies are timed in both types, the
   latter beside the attention kernel's time at its N.  Then the same weights
   in a generator built with ``rab_tail="fused"``: the request held
   against the unfused card
   output, its launch counts (the fused tail 48 times a forward, the
   separate pool and gate none) and its latency;
5. train, correctness: one float32 WGAN-GP step of the full-width x4
   ``train.Trainer`` (generator, CBAM patch discriminator, VGG19 content
   term; seeded fan-in-scaled conv weights, gains 0.5) at batch 2 of
   54^2 -> 216^2 on the card, held against the CPU plain path's step in
   float64 from the same weights, batch and penalty weights: the losses
   must agree, every G and D parameter gradient must stay within a fixed
   bound per network (GRAD_TOL), which the CPU's own float32 step must meet
   too, and the launch counters must show K1-K5 at the counts the module
   structure predicts, the gate backward in the generator and in the
   discriminator (penalty included); once with the unfused RAB tails and
   once with the fused ones (fused on both sides), where it also prints how
   far the fused card's sr and D gradients lie from the unfused card's;
   then one batch of the validation sweep (one image, so the fused tail and
   the SGAM at B = 1): the fused sr against the unfused one on the card;
6. train, timing: steps at batch 16 of 54^2 -> 216^2 in float32 (TF32 off)
   and in the mixed precision of ``cfg.bf16``, unfused and fused, in ms per
   step and MP/s of HR output; the mixed-precision losses must stay finite;
7. the training entry point: ``sradsgan_tpu_torch.cli train --model
   sradsgan --scale 4 --data synthetic --model-kwargs '{"rab_tail":
   "fused"}' --no-final-eval --epochs 2`` at the default sizes (512
   synthetic images in batches of 16, mixed precision, a validation sweep
   of 64 images after each epoch), in this process: it must write
   ``ckpt_best.pt``, ``loss_log.txt`` and ``val_log.txt``, end with finite
   metrics, launch every kernel at the counts the loop's structure gives,
   and it prints the data feed's share of the last epoch;
8. the evaluation protocol: ``evaluation.validate.mfe_new_validate_by_class``
   over the synthetic test set (64 images, 216^2 HR, bilinear 54^2 LR,
   batches of 8) for the full-width x4 generator (seeded fan-in weights)
   with AlexNet LPIPS (seeded trunk), unfused and fused: exact launch
   counts per sweep (K1, K2 48 and K3 once a forward; fused K6 48 and K3
   once), finite table rows, the sweep's seconds, images/s and the split
   between device forward, LPIPS and host scoring; the first batch held
   against the CPU plain path (SR within SLICE_TOL of max|ref|, LPIPS
   within 1e-4 relative, each row within ROW_BARS); then ``cli
   validate-by-class`` (its table and its CSV's LPIPS columns) and ``cli
   train`` with its final table, both with ``--lpips`` at 64^2, with their
   launch counts;
9. the model zoo: the seven other generators (EDSR, SRGAN, DRCAN, DSSR,
   SRAGAN, NDSRGAN, AMSSRN) at x4 and their published widths and depths,
   seeded fan-in weights with every gain non-zero: a batch of four 54^2
   requests on the card against the CPU plain path, bf16 against float32,
   the request's latency; SRAGAN, whose 72 CA-SA tails, PAM and CBAM D run
   the kernels, also fused, then its train step against float64 (3 groups,
   each tensor held to the fixed bars or, where float32 steps without the
   kernels miss them, to twice what those read: SRAGAN_CHECK) and timed at
   batch 16 with exact launches;
   a bf16 step of SRGAN, DRCAN and NDSRGAN; ``cli train --model X`` for
   each of the seven at small widths;
10. HAT, the ninth generator, at its published width and depth (embed 96,
   6 groups of 6 HABs, 6 heads, window 9, x4; seeded fan-in weights): the
   batch-1 forward on the card against the CPU plain path, a batch of four
   54^2 requests in float32 and bf16 (ms a request, no kernel launched),
   its L1 step at batch 16 of 54^2 -> 216^2 in float32 and mixed precision
   (ms/step, MP/s, peak GiB, finite loss) and ``cli train --model hat
   --steps 2`` at small widths;
11. export: the full-width x4 flagship (unfused and fused) and HAT written
   by ``serving.export_model`` at batch 1 of 54^2 on the card, each loaded
   in a fresh interpreter that imports the port alone
   (``serving.load_exported``), and the flagship exported on the CPU and
   loaded onto the card: its output against the eager generator's (the
   same kernels on the same input), the kernel launches of one call of the
   loaded program (the registered ops: K1, K2 48 and K3 once unfused; K6
   48 and K3 once fused; none for HAT), and its latency against the eager
   generator's over alternating turns;
12. GDP diffusion at the shipped width (``gdp_train_54_216``: UNet inner
   64, mults (1, 2, 4, 8), 2 res blocks, attention at rate 8; seeded
   fan-in weights): a 216^2 forward against the CPU plain path and in
   bf16; a float32 step of the x0 loss at batch 2 of 64^2 against the
   CPU's float64 step (the same t and noise; the loss within LOSS_TOL,
   every gradient tensor within 1e-3 of its max|ref|, the CPU's float32 step
   as the control); ``DiffusionTrainer``'s step at batch 4 of 216^2 in
   float32 and mixed precision (ms, MP/s, peak GiB, TFLOP/s from the
   hooks' FLOP count and its share of the peak); ms a denoising step and
   the whole 1000-step chain of one 216^2 image in both; an 8-step chain
   at 64^2 fed the same noise on the card and on the CPU;
   ``diffusion-train``, ``diffusion-validate`` (plain and
   ``--continuous``) and ``diffusion-sample`` at 64^2; no kernel launched;
13. the data mesh (``parallel/mesh.py``) with the flagship at full width
   (seeded fan-in weights, float32): one NCCL rank's step at batch 16
   against the step without a process group (launches exact, GRAD_TOL),
   both timed over alternating turns; two gloo ranks spawned on the card
   (``tools/dp_check.py``) at a global batch of 16, and of 4 x 216^2 for
   ``DiffusionTrainer``, against the one-process card step (launches,
   losses, every gradient, the D's running statistics) and bit-equal to
   each other after three steps; with more than one card, the same with
   one NCCL rank a card, the step then timed in as many turns as on one;
14. halo-tiled inference and weights without JAX: the full-width x4
   flagship (seeded fan-in weights, float32) on a 270 x 250 LR scene, 25
   tiles of 70^2 in chunks of 16: (a) one process on the card against
   ``tiled_super_resolve`` on the CPU (SLICE_TOL) with exact launches; (b)
   the ``tiled`` scenario of phase 13's spawns (two gloo ranks on this
   card; with more cards one NCCL rank a card): every rank's whole scene
   bit-equal to the others' and to (a)'s or within TOL[float32], each
   rank's launches exact; (c) rank 0 alone against the ranks over
   alternating turns; (d) a seeded flagship and HAT written as the
   reference's ``.pkl`` and read back by ``tools/from_reference.py``, and
   a torchvision-layout VGG19 ``.pth`` read by ``load_vgg19``, each
   bit-equal on the card to the module it came from;
15. the data variants and the offline tools (needs Pillow): (a)
   ``ops/degrade.srmd_preprocess`` at 16 x 216^2, 21^2 kernels, x4, noise
   0.01, isotropic and anisotropic, within 1e-5 of the CPU composition of
   the same draws, ms a call; on a UCMerced-shaped tree made from a seed
   (21 classes x 20 pngs of 256^2): (b) ``FolderDataset(augment=True)``,
   ``AugmentedCropDataset``, ``NoisyDataset`` (gaussian, sp, poisson) and
   ``BlurDegradedDataset`` at 216^2, x4, through the loader at batch 16
   with ``augment_rng``, host images/s, each feeding two float32 flagship
   steps with exact launches and finite losses; (c) ``prepare_triplets``
   (images/s) feeding ``TripletFolderDataset(hflip=True)``, and
   ``iter_triplet_records`` a dict-backed ``LMDBTripletDataset``, each
   feeding two ``DiffusionTrainer`` steps at 4 x 216^2, no kernel
   launched; (d) ``SceneClassifier(image_size=216)``: feature images/s,
   eight images' features within 1e-4 of max|ref| of the CPU, the head's
   training ms and its accuracy over the tree; (e) ``tools/dryrun.entry()``
   on the card against the CPU with exact launches, and
   ``dryrun_multichip`` over one NCCL rank a card.

It prints the kernels' record as one JSON line before the last, and ends
with ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

import torch.nn.functional as F

from sradsgan_tpu_torch import cli
from sradsgan_tpu_torch.config import DataConfig
from sradsgan_tpu_torch.data.datasets import build_test_dataset
from sradsgan_tpu_torch.data.loader import DataLoader
from sradsgan_tpu_torch.evaluation.tiled import forward_numpy
from sradsgan_tpu_torch.evaluation.validate import (
    Evaluator, _score_pair, format_by_class_table, mfe_new_validate_by_class)
from sradsgan_tpu_torch.losses import gan as gan_losses
from sradsgan_tpu_torch.losses.lpips import lpips_fn, lpips_is_calibrated
from sradsgan_tpu_torch.models import (config_for_model, create_discriminator,
                                       create_generator, get_spec)
from sradsgan_tpu_torch.models.sradsgan import RAB
from sradsgan_tpu_torch.nn.attention import (KERNEL_POOL, ChannelGate,
                                             LocalAttention, SpatialGate,
                                             SpatialSelfAttention)
from sradsgan_tpu_torch.ops import (_build, pooling, rab_tail, sgam_flash,
                                    spatial_gate)
from sradsgan_tpu_torch.serving import Predictor, export_model
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
# The card's published peaks (NVIDIA H100 SXM data sheet), for the bounds:
# device memory rate, and dense FLOP/s by the inputs' type.  bf16 runs on
# the tensor cores at 989 TFLOP/s.  float32 inputs may too, and keep
# float32 accuracy there, as the sum of three TF32 products (high and
# residual parts) at the fewest: 495 / 3 = 165 TFLOP/s, above the 67 of the
# CUDA cores, so that is the rate no float32 implementation can beat.
# Exponentials go through the special function units, 16 a clock on each
# multiprocessor, at nvidia-smi's clocks.max.sm.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
EXPS_PER_CLOCK_PER_SM = 16
L2_BYTES = 50 * 2 ** 20
# The gates' shapes: the generator's and the discriminator's CBAM in the
# train step, and a ragged tile; the serving request's batch of four, the
# validation sweep's single image and one 216^2 image.
TRAIN_SHAPES = ((16, 64, 54, 54), (16, 256, 27, 27), (3, 64, 27, 31))
GATE_SERVING_SHAPES = ((4, 64, 54, 54), (1, 64, 54, 54), (1, 64, 216, 216))

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
    "rab_tail": dict(
        cuda=rab_tail.rab_tail_cuda,
        source="sradsgan_tpu_torch/csrc/rab_tail.cu",
        replaces="sradsgan_tpu/ops/pallas/rab_tail.py:132"),
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
    _sass_counts()


def _sass_counts() -> None:
    """Where the toolkit has cuobjdump: how many tensor-core (HGMMA: wgmma;
    HMMA: bf16 and TF32 mma.sync) and asynchronous-copy (LDGSTS: cp.async)
    instructions each attention kernel and the fused RAB tail (its fuse
    product) were compiled to, summed over a kernel's bf16 and its float32
    instantiations.  Either kind without them is a failure."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("sass: no cuobjdump in the toolkit; not counted")
        return
    lib = _build.BUILD_DIR / _build.source_hash() / _build.LIB_NAME
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernel = next((k for k in ("position_attention_kernel",
                                       "attention_bwd_kernel",
                                       "rab_tail_kernel")
                           if k in name), None)
            dtype = "bf16" if "__nv_bfloat16" in name else "f32"
            current = (kernel, dtype) if kernel else None
            if current:
                counts.setdefault(current, {"HGMMA": 0, "HMMA": 0,
                                            "LDGSTS": 0, "functions": 0})
                counts[current]["functions"] += 1
        elif current:
            for op in ("HGMMA", "HMMA", "LDGSTS"):
                if f" {op}" in line:
                    counts[current][op] += 1
    for (kernel, dtype), c in sorted(counts.items()):
        print(f"sass: {kernel} {dtype}: {c['functions']} instantiations, "
              f"{c['HGMMA']} HGMMA, {c['HMMA']} HMMA, {c['LDGSTS']} LDGSTS")
        if not ((c["HGMMA"] or c["HMMA"]) and c["LDGSTS"]):
            fail(f"{kernel} {dtype} was compiled without tensor-core or "
                 "asynchronous-copy instructions")
    if len(counts) != 6:
        fail(f"sass: found {sorted(counts)} of the tensor-core kernels")
    if not counts[("rab_tail_kernel", "bf16")]["HMMA"]:
        fail("the bf16 fused RAB tail was compiled without tensor-core "
             "products for its fuse")
    for kernel in ("position_attention_kernel", "attention_bwd_kernel"):
        if not counts[(kernel, "bf16")]["HGMMA"]:
            fail(f"the bf16 {kernel} was compiled without warpgroup "
                 "products")


def phase_plans() -> dict:
    """The launches the three row-strip kernels take at the main path's
    shapes, as their C side chooses them from the card's SM count and a
    block's shared memory: for the gate forward, rows a strip; for the
    other two, bands an image of the stencils' launch, strips an image of
    the statistics launch and of the outputs' launch."""
    device = torch.device("cuda", 0)
    plans = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).rpartition(".")[2]
        for shape in TRAIN_SHAPES + GATE_SERVING_SHAPES:
            plans[f"spatial_gate {name} {shape}"] = _build.plan(
                "sg_spatial_gate", device, shape, dtype)
        for shape in ((16, 64, 54, 54), (16, 256, 27, 27)):
            plans[f"spatial_gate_bwd {name} {shape}"] = _build.plan(
                "sg_spatial_gate_bwd", device, shape, dtype)
        for b in (16, 4, 1):
            plans[f"rab_tail {name} {(b, 64, 54, 54)}"] = _build.plan(
                "sg_rab_tail", device, (b, 64, 4, 54, 54), dtype)
    for case, plan in plans.items():
        print(f"strips: {case}: {plan}")
    return plans


def _randn(shape, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to("cuda", dtype)


def _cold(call, *inputs):
    """``call(*inputs)`` as a zero-argument call that takes its inputs in
    turn from clones whose total is four times the card's L2 (at most 64
    sets), so that a replayed graph of calls reads them from device memory:
    the time of a kernel whose inputs were just written by other kernels
    over other data, as in the model."""
    size = sum(t.numel() * t.element_size() for t in inputs)
    copies = min(max(2, -(-4 * L2_BYTES // size)), 64)
    sets = [tuple(t.clone() for t in inputs) for _ in range(copies)]
    turn = [0]

    def run():
        turn[0] = (turn[0] + 1) % copies
        return call(*sets[turn[0]])
    return run


def _dw_contraction_case(x, w):
    """The plain dw contraction alone, on planes of x's shape: one
    ``torch.stack`` and one cuDNN weight-gradient call, what the gate's
    backward ran after its kernel before the kernel summed dw itself.
    Returns (call, inputs) for :func:`cuda_ms` and :func:`_cold`."""
    x32 = x.float()
    inputs = (_randn(x32[:, 0].shape, torch.float32, 21), x32.mean(1),
              x32.amax(1))

    def call(ds, mean, mx):
        return spatial_gate.dw_contraction(
            ds, torch.stack([mean, mx], dim=1), w)
    return call, inputs


def _rab_tail_params(c: int):
    """Float32 parameters of one fused tail on the card, with live CLAM
    hidden units (|W1| + 0.05) and gates away from saturation."""
    hidden = max(c // 16, 1)
    return (_randn((c, hidden), torch.float32, 11, scale=0.02).abs() + 0.05,
            _randn((hidden, c), torch.float32, 12, scale=0.1),
            _randn((1, 2, 7, 7), torch.float32, 13, scale=0.3),
            _randn((c, c), torch.float32, 14, scale=0.5 / c ** 0.5),
            _randn((c,), torch.float32, 15, scale=0.05))


def _unfused_tail(params, dtype):
    """The composition the fused tail replaces, as the unfused generator
    runs it on the card: the pool kernel, the MLP, the gate kernel, cuDNN's
    1x1 conv and the residual add, over the same weights."""
    w1, w2, slam_w, fuse_w, fuse_b = params
    c = fuse_w.shape[0]
    la = LocalAttention(c).to("cuda")
    with torch.no_grad():
        la.ca.fc1.weight.copy_(w1.t()[:, :, None, None])
        la.ca.fc2.weight.copy_(w2.t()[:, :, None, None])
        la.sa.conv1.weight.copy_(slam_w)
        la.conv.weight.copy_(fuse_w.t()[:, :, None, None])
        la.conv.bias.copy_(fuse_b)
    la.ca.to(dtype)
    la.conv.to(dtype)

    def run(t, x_res):
        with torch.no_grad():
            return la.tail(t, x_res)
    return run


def _sdpa_library(q, k, v, dout):
    """(forward ms, backward ms, backends) of
    ``F.scaled_dot_product_attention(q, k, v, scale=1.0)``, the one PyTorch
    call that computes the SGAM's function (d_qk 8, d_v 64), and of its
    autograd backward; ``backends`` says which of PyTorch's SDPA backends
    take these inputs when asked for alone.  A yardstick only: the port
    never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def heads(t):  # (B, N, d) -> (B, 1, N, d)
        return t[:, None]

    def forward():
        return F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                              scale=1.0)

    backends = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                forward()
            torch.cuda.synchronize()
            backends[backend.name] = "ran"
        except RuntimeError:
            backends[backend.name] = "refused"
    iters = 10
    for _ in range(3):
        forward()
    fwd_ms = _event_ms(lambda: [forward() for _ in range(iters)], iters)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*map(heads, leaves), scale=1.0)

    def backward():
        torch.autograd.grad(out, leaves, heads(dout), retain_graph=True)

    for _ in range(3):
        backward()
    bwd_ms = _event_ms(lambda: [backward() for _ in range(iters)], iters)
    return fwd_ms, bwd_ms, backends


def _gate_case(x, w):
    """The gate forward's case of :func:`_kernel_cases` for input x."""
    b, _, h, wd = x.shape
    n = x.numel()
    return ("spatial_gate", "", x.dtype, tuple(x.shape),
            lambda: spatial_gate.spatial_gate_cuda(x, w),
            lambda: spatial_gate.spatial_gate_plain(x, w),
            2 * n * x.element_size() + 98 * 4, 3 * n + b * h * wd * 2 * 98,
            {"cold_ms": _cold(
                lambda x: spatial_gate.spatial_gate_cuda(x, w), x)})


def _kernel_cases():
    """(kernel, label, dtype, shape, run kernel, run plain, bytes, flops,
    extra): zero-argument calls at the train step's shapes first, then the
    serving path's and the validation sweep's (one image at a time).
    ``bytes`` counts each input read once and each output written once,
    ``flops`` the operations of the function on these inputs; ``extra`` maps
    a label to another zero-argument call timed beside the kernel (the
    bytes-bound kernels with their inputs out of the L2, see :func:`_cold`;
    the gate backward without its dw stage and the plain dw contraction it
    replaced; the unfused composition; the library call is timed apart), and for the
    attention kernels ``"exps"`` to the exponentials the function needs (one
    a query-key pair) and ``"iters"`` to the calls per timing."""
    w = _randn((1, 2, 7, 7), torch.float32, 1, scale=0.3)
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        for shape in TRAIN_SHAPES:
            x = _randn(shape, dtype, 2)
            g = _randn(shape, dtype, 6)
            b, c, h, wd = shape
            n, px = x.numel(), b * h * wd
            yield ("avg_max_pool", "", dtype, shape,
                   lambda x=x: pooling.avg_max_pool_cuda(x),
                   lambda x=x: pooling.avg_max_pool_plain(x),
                   (n + 2 * b * c) * es, 2 * n,
                   {"cold_ms": _cold(pooling.avg_max_pool_cuda, x)})
            yield _gate_case(x, w)
            # K4 whole (dx and dw), then its parts apart: the kernel with
            # its dw stage left out, and the plain contraction
            contraction, planes = _dw_contraction_case(x, w)
            yield ("spatial_gate_bwd", "", dtype, shape,
                   lambda x=x, g=g:
                   spatial_gate.spatial_gate_bwd_cuda(x, w, g),
                   lambda x=x, g=g:
                   spatial_gate.spatial_gate_bwd_plain(x, w, g),
                   3 * n * es + 2 * 98 * 4, 8 * n + px * 6 * 98,
                   {"cold_ms": _cold(
                       lambda x, g:
                       spatial_gate.spatial_gate_bwd_cuda(x, w, g), x, g),
                    "without_dw_ms": lambda x=x, g=g:
                    spatial_gate.spatial_gate_bwd_cuda(x, w, g,
                                                       with_dw=False),
                    "without_dw_cold_ms": _cold(
                        lambda x, g: spatial_gate.spatial_gate_bwd_cuda(
                            x, w, g, with_dw=False), x, g),
                    "plain_dw_contraction_ms":
                    lambda c=contraction, p=planes: c(*p),
                    "plain_dw_contraction_cold_ms":
                    _cold(contraction, *planes)})
        # the gate forward also at the serving request's and the
        # validation sweep's shapes (a batch of four, one image, one 216^2)
        for shape in GATE_SERVING_SHAPES:
            yield _gate_case(_randn(shape, dtype, 2), w)
        # the fused RAB tail at the train step's, the serving request's and
        # the validation sweep's shapes and a ragged one
        for shape in ((16, 64, 54, 54), (4, 64, 54, 54), (1, 64, 54, 54),
                      (3, 64, 27, 31)):
            b, c, h, wd = shape
            t = _randn(shape, dtype, 8)
            x_res = _randn(shape, dtype, 9)
            params = _rab_tail_params(c)
            unfused = _unfused_tail(params, dtype)
            n, px = t.numel(), b * h * wd
            _check_rab_tail_maxima(
                t, rab_tail.rab_tail_cuda(t, x_res, *params))
            yield ("rab_tail", "", dtype, shape,
                   lambda t=t, x_res=x_res, params=params:
                   rab_tail.rab_tail_cuda(t, x_res, *params),
                   lambda t=t, x_res=x_res, params=params:
                   rab_tail.rab_tail_plain(t, x_res, *params),
                   3 * n * es + 4 * (3 * px + 3 * b * c
                                     + sum(p.numel() for p in params)),
                   px * (2 * c * c + 8 * c + 2 * 98),
                   {"composition_ms":
                    lambda t=t, x_res=x_res, run=unfused: run(t, x_res),
                    "cold_ms": _cold(
                        lambda t, x_res, params=params:
                        rab_tail.rab_tail_cuda(t, x_res, *params), t, x_res),
                    "composition_cold_ms": _cold(unfused, t, x_res)})
        # SGAM at the train step's batch, N = 54^2, then a ragged 27^2, the
        # serving record's batch of two and the validation sweep's of one
        # and one 216^2 image, the serving path's largest bucket, whose plain
        # version goes by blocks of queries (its energy would be 8.7 GB)
        for b, n in ((16, 2916), (16, 729), (2, 2916), (1, 2916), (1, 46656)):
            q = _randn((b, n, 8), dtype, 3, scale=0.5)
            k = _randn((b, n, 8), dtype, 4, scale=0.5)
            v = _randn((b, n, 64), dtype, 5)
            dout = _randn((b, n, 64), dtype, 7)
            shape = (b, n, 8, 64)
            fwd_bytes = b * n * (8 + 8 + 64 + 64) * es
            fwd_flops = 2 * b * n * n * (8 + 64)
            counts = {"exps": b * n * n, "iters": 20 if n < 10000 else 3}
            yield ("position_attention", "", dtype, shape,
                   lambda q=q, k=k, v=v:
                   sgam_flash.position_attention_cuda(q, k, v),
                   lambda q=q, k=k, v=v, plain=(
                       sgam_flash.position_attention_plain if n < 10000 else
                       sgam_flash.position_attention_plain_chunked):
                   plain(q, k, v),
                   fwd_bytes, fwd_flops, dict(counts))
            if b != 16:  # forward only: served or swept under no-grad
                continue
            yield ("position_attention", " +lse", dtype, shape,
                   lambda q=q, k=k, v=v: sgam_flash.position_attention_cuda(
                       q, k, v, with_lse=True)[0],
                   lambda q=q, k=k, v=v:
                   sgam_flash.position_attention_plain(q, k, v),
                   fwd_bytes + b * n * 4, fwd_flops, dict(counts))
            out, lse = sgam_flash.position_attention_cuda(q, k, v,
                                                          with_lse=True)
            yield ("position_attention_bwd", "", dtype, shape,
                   lambda q=q, k=k, v=v, out=out, dout=dout, lse=lse:
                   sgam_flash.position_attention_bwd_cuda(q, k, v, out, dout,
                                                          lse),
                   lambda q=q, k=k, v=v, dout=dout:
                   sgam_flash.position_attention_bwd_plain(q, k, v, dout),
                   b * n * ((8 + 8 + 64) * 2 + 64 + 64) * es + b * n * 4,
                   2 * b * n * n * (8 + 64 + 64 + 8 + 8), dict(counts))


def _check_rab_tail_maxima(t: torch.Tensor, got: tuple) -> None:
    """max_t is a plain maximum: exact.  max_u is the maximum of t * gate_c
    with the kernel's own gate (its MLP and sigmoid round a few ulp apart
    from torch's), so it must equal, bit for bit, the maximum of the
    products taken from the kernel's gate_c: the backward finds the tied
    maxima by that equality."""
    _, gate_c, _, _, max_u, _, max_t = got
    t32 = t.float()
    if not torch.equal(max_t, t32.amax((2, 3))):
        fail(f"rab_tail {t.dtype} {tuple(t.shape)}: max_t is not the max")
    if not torch.equal(max_u, (t32 * gate_c[:, :, None, None]).amax(1)):
        fail(f"rab_tail {t.dtype} {tuple(t.shape)}: max_u is not the max of "
             "t * gate_c")


def _exps_per_s() -> float:
    """The card's peak rate of exponentials, from its multiprocessor count
    and nvidia-smi's highest SM clock (MHz)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EXPS_PER_CLOCK_PER_SM * sms * mhz * 1e6


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns, per kernel, the
    error, the times and the bound at its first (train step, float32) case,
    the K3 time with the log-sum-exp store, and under ``cases`` the times
    and bounds of every case."""
    record = {}
    exps_per_s = _exps_per_s()
    for (name, label, dtype, shape, kernel, plain, n_bytes, flops,
         extra) in _kernel_cases():
        exps = extra.pop("exps", 0)
        iters = extra.pop("iters", 20)
        got = kernel()
        if name == "spatial_gate" and not torch.equal(got, kernel()):
            fail(f"{name} {dtype} {shape}: two calls differ")
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
        del got, want
        # plain, kernel, kernel, plain: drift hits both alike
        p1 = cuda_ms(plain, iters)
        k1 = cuda_ms(kernel, iters)
        k2 = cuda_ms(kernel, iters)
        p2 = cuda_ms(plain, iters)
        ms, eager_ms = ((a + b) / 2 for a, b in zip(k1, k2))
        plain_ms, plain_eager_ms = ((a + b) / 2 for a, b in zip(p1, p2))
        extras = {key: cuda_ms(fn)[0] for key, fn in extra.items()}
        if "composition_cold_ms" in extras:  # under 1: the fused tail wins
            extras["cold_over_composition_cold"] = (
                extras["cold_ms"] / extras["composition_cold_ms"])
        terms = {"bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
                 "products": flops / PEAK_FLOPS[dtype] * 1e3,
                 "exponentials": exps / exps_per_s * 1e3}
        bound_term = max(terms, key=terms.get)
        bound_ms = terms[bound_term]
        if not ms >= bound_ms:  # a fault of the bound, not a fast kernel
            print(f"OVER BOUND: {name}{label} {dtype} {shape} took "
                  f"{ms:.4f} ms, under its bound of {bound_ms:.4f} ms "
                  f"({bound_term})")
        # exponentials are operations too: the term says which kind
        bound_by = "bytes" if bound_term == "bytes" else "operations"
        print(f"kernel {name + label:<24} {str(dtype):<14} {str(shape):<18} "
              f"max_abs_err {max(errs):.3e} (of max|ref|: "
              f"{', '.join(f'{r:.2e}' for r in rels)}; tol "
              f"{TOL[dtype]:.0e})  device: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_term}: "
              f"{n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP, "
              f"{exps / 1e6:.1f} M exps)"
              + "".join(f", {k} {v:.4f}" for k, v in extras.items())
              + f"; eager: kernel {eager_ms:.4f} ms, plain "
              f"{plain_eager_ms:.4f} ms")
        if label:
            record[name].setdefault("ms_with_lse", ms)
            continue
        if name not in record:
            record[name] = {"max_abs_err": max(errs), "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "bound_term": bound_term,
                            "library_ms": None,
                            "eager_ms": eager_ms,
                            "plain_eager_ms": plain_eager_ms,
                            "dtype": str(dtype), "shape": list(shape),
                            **extras, "cases": {}}
        case = f"{str(dtype).rpartition('.')[2]} {'x'.join(map(str, shape))}"
        record[name]["cases"][case] = {
            "max_rel_err": max(rels), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_term": bound_term, **extras}

    # the library yardstick of K3 and K5, at their first case's shape
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn((16, 2916, 8), dtype, 3, scale=0.5)
        k = _randn((16, 2916, 8), dtype, 4, scale=0.5)
        v = _randn((16, 2916, 64), dtype, 5)
        dout = _randn((16, 2916, 64), dtype, 7)
        fwd_ms, bwd_ms, backends = _sdpa_library(q, k, v, dout)
        key = "library_ms" if dtype == torch.float32 else "library_bf16_ms"
        record["position_attention"][key] = fwd_ms
        record["position_attention_bwd"][key] = bwd_ms
        print(f"library scaled_dot_product_attention(scale=1.0) {dtype} "
              f"(16, 2916, 8, 64): forward {fwd_ms:.4f} ms, autograd "
              f"backward {bwd_ms:.4f} ms; backends asked for alone: "
              f"{backends}")
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


def _pools(model) -> int:
    """Channel gates that take the fused avg+max pool ("Avg|Max"; the
    single-stat gates, DSSR's and the "Avg"/"Max" ablations', take a plain
    mean or max)."""
    return sum(isinstance(m, ChannelGate) and m.pool_mode == KERNEL_POOL
               for m in model.modules())


def _gates(model) -> int:
    """Spatial gates that run the gate kernel ("Avg|Max"; a single-stat
    gate runs the plain stencil)."""
    return sum(isinstance(m, SpatialGate) and m.pool_mode == KERNEL_POOL
               for m in model.modules())


def _sgams(model) -> int:
    """SGAMs that run the attention kernel (the patch D's global attention
    is built plain)."""
    return sum(isinstance(m, SpatialSelfAttention) and not m.plain
               for m in model.modules())


def forward_launches(generator, forwards: int = 1) -> dict:
    """Kernel launches of ``forwards`` no-grad generator forwards, from the
    module structure: per "Avg|Max" channel gate a pool (K1) and per
    "Avg|Max" spatial gate a gate (K2), but a fused tail (K6, which pools
    inside its own launch) in place of both for each tail that
    ``rab_tail="fused"`` fuses (``LocalAttention.fused``: 'CA-SA',
    "Avg|Max", with the conv); the attention kernel (K3) once per SGAM at
    a kernel width.  At the defaults the local attentions are one per RAB
    and one per group in SRADSGAN (48), one per BasicBlock and one per
    group in SRAGAN (72); the grammar's modes change which gates each
    holds (GRAMMAR_CASES)."""
    fused = sum(isinstance(m, LocalAttention) and m.fused
                for m in generator.modules())
    return {"avg_max_pool": forwards * (_pools(generator) - fused),
            "spatial_gate": forwards * (_gates(generator) - fused),
            "position_attention": forwards * _sgams(generator),
            "spatial_gate_bwd": 0, "position_attention_bwd": 0,
            "rab_tail": forwards * fused}


def phase_serving(smi: str, k3_ms: dict) -> dict:
    """``k3_ms``: the attention forward's time at one 216^2 image by type,
    from phase_kernels, to set beside the 130x130 request's latency."""
    scale = 4
    model = create_generator("sradsgan", scale, seed=0)
    with torch.no_grad():
        model.GAB_UP.ca.gamma.fill_(0.5)
        model.GAB_UP.sa.gamma.fill_(0.5)
    cpu_model = copy.deepcopy(model).eval()
    fused_model = create_generator("sradsgan", scale, seed=0,
                                   rab_tail="fused")
    fused_model.load_state_dict(model.state_dict())  # strict: the same tree

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
    # one forward per request; the 25 tiles of 240x240 fit one call
    expected = forward_launches(model, forwards=4)
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

    batch = requests["batch4_54x54"]
    fused_pred = Predictor(fused_model, scale)
    reset_launches()
    fused_out = fused_pred(batch)
    torch.cuda.synchronize()
    fused_launches = read_launches()
    print(f"fused serving path launches: {fused_launches}")
    if fused_launches != forward_launches(fused_model):
        fail(f"fused launch counts {fused_launches} differ from the path's "
             f"{forward_launches(fused_model)}")
    ref = outs["batch4_54x54"]
    err = float(np.abs(fused_out - ref).max())
    bound = SLICE_TOL * float(np.abs(ref).max())
    print(f"fused vs unfused on the card (4 x 54^2, f32): max|d| {err:.3e} "
          f"<= {bound:.3e}")
    if not (np.isfinite(fused_out).all() and err <= bound):
        fail("the fused request disagrees with the unfused one")

    pred_bf16 = Predictor(model, scale, dtype=torch.bfloat16)
    fused_bf16 = Predictor(fused_model, scale, dtype=torch.bfloat16)
    out_bf16 = pred_bf16(batch)
    fused_out_bf16 = fused_bf16(batch)
    if not (np.isfinite(out_bf16).all() and np.isfinite(fused_out_bf16).all()):
        fail("bf16 output is not finite")
    db = psnr(out_bf16, outs["batch4_54x54"])
    fused_db = psnr(fused_out_bf16, outs["batch4_54x54"])
    print(f"bf16 vs f32 on the batch of four: PSNR {db:.2f} dB unfused, "
          f"{fused_db:.2f} dB fused (peak = the f32 output's range)")
    if not fused_db >= db - 3.0:
        fail("the fused bf16 request is further than 3 dB behind the "
             "unfused one")

    mpix = batch.shape[0] * (54 * scale) ** 2 / 1e6
    serving = {"psnr_bf16_vs_f32_db": db, "fused_psnr_bf16_vs_f32_db": fused_db}
    for label, p in (("f32", pred), ("fused_f32", fused_pred),
                     ("bf16", pred_bf16), ("fused_bf16", fused_bf16)):
        ms = latency_ms(p, batch)
        serving[f"{label}_ms"] = ms
        serving[f"{label}_mp_per_s"] = mpix / (ms / 1e3)
        print(f"serving batch 4 x 54^2 -> 216^2 {label}: {ms:.2f} ms/request, "
              f"{mpix / (ms / 1e3):.3f} MP/s of output [{smi}]")
    # the 216^2 bucket: one image, the attention at N = 46 656
    big = requests["130x130"]
    for label, p, dtype in (("f32", pred, torch.float32),
                            ("bf16", pred_bf16, torch.bfloat16)):
        ms = latency_ms(p, big, iters=5)
        serving[f"bucket216_{label}_ms"] = ms
        serving[f"bucket216_{label}_k3_share"] = k3_ms[dtype] / ms
        print(f"serving 130x130 (216^2 bucket) {label}: {ms:.2f} ms/request, "
              f"of which the attention kernel {k3_ms[dtype]:.4f} ms "
              f"({k3_ms[dtype] / ms:.1%}) [{smi}]")
    return {"launches": launches, "fused_launches": fused_launches,
            "serving": serving}


def step_launches(trainer) -> dict:
    """Kernel launches one train step makes, from the module structure: the
    generator's forward (:func:`forward_launches`), and a pool (K1) and a
    gate (K2) in the discriminator's CBAM for each of the step's D forwards
    (sr in the G step, hr, sr.detach() and, for WGAN-GP, the
    interpolates); K5 once per SGAM.  The gate backward (K4) runs once per
    gate of the generator's backward (a fused tail's backward still runs K4
    for its SLAM part) and, per gate of the discriminator, once per D
    forward that the losses backpropagate through plus, for WGAN-GP, the
    penalty's inner gradient: five times (the backward through D(sr) in the
    G step, the penalty's gradient, and in the D step's backward through
    D(hr), D(sr.detach()) and, from the penalty's second order reaching the
    gate's output through the BatchNorms after it, D(interpolates))."""
    g = trainer.generator
    counts = forward_launches(g)
    d_gates = (_gates(trainer.discriminator)
               if trainer.discriminator is not None else 0)
    wgan = trainer.cfg.gan.gan_type == "wgan-gp"
    d_forwards = 4 if wgan else 3
    counts["avg_max_pool"] += d_forwards * d_gates
    counts["spatial_gate"] += d_forwards * d_gates
    counts["spatial_gate_bwd"] = (_gates(g) + (d_forwards + wgan) * d_gates)
    counts["position_attention_bwd"] = counts["position_attention"]
    return counts


def fan_in_init(model: torch.nn.Module, seed: int) -> None:
    """Conv and dense kernels normal(0, 0.5 / sqrt(fan_in)) and biases
    normal(0, 0.05),
    drawn on the CPU, as the CPU tests draw them: activations of order one
    through all 36 RABs.  At the JAX init (std 0.02) the deep gates see
    vanishing signals and their gradients are sums that cancel: a CPU
    float32 step then differs from the float64 one by 1.7e-2 (8 threads)
    to 3.3e-2 (1 thread) of a tensor's largest, so no fixed bound could
    tell a kernel fault from float32 rounding there."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
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
    per-channel shift) and an SGAM key conv's bias (it shifts each query's
    energies by a constant, which the softmax removes)."""
    names = {n for n, _ in model.named_parameters()
             if n.endswith("key_conv.bias")}
    layers = list(model.named_modules())
    for (name, m), (_, nxt) in zip(layers, layers[1:]):
        if (isinstance(m, torch.nn.Conv2d) and m.bias is not None
                and isinstance(nxt, torch.nn.BatchNorm2d)):
            names.add(f"{name}.bias")
    return names


# The gradient checks (phase_train_correctness): the model, its generator's
# arguments, gains that differ from make_trainer's 0.5, and the bars.
FLAGSHIP_CHECK = {"model": "sradsgan", "model_kwargs": {}, "gains": {},
                  "tol": GRAD_TOL}


def _fan_in_trainer(device: str, float64: bool = False,
                    rab_tail: str = "unfused", check: dict = FLAGSHIP_CHECK):
    trainer = make_trainer("f32", device=device, rab_tail=rab_tail,
                           model=check["model"], **check["model_kwargs"])
    for net in (trainer.generator, trainer.discriminator):
        fan_in_init(net, seed=3)
    with torch.no_grad():
        for name, value in check["gains"].items():
            trainer.generator.get_parameter(name).fill_(value)
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


# A LeakyReLU input within KINK_EPS of its layer's max |ref| of zero is a
# kink that float32 rounding may put on either side (KINK_EPS is 100 x the
# 1e-8 relative size of those the flagship's ablations put there on an
# H100 80GB HBM3, 700 W).  Both sides of an aligned kink lie within that
# band, and a layer with more than KINK_CAP of them fails the check (the
# runs read 5 and 7 in all).
KINK_EPS = 1e-6
KINK_CAP = 32


def _rab_conv1s(generator) -> dict:
    """Each RAB's conv1, whose output is the RAB's LeakyReLU's input."""
    return {n: m.conv1 for n, m in generator.named_modules()
            if isinstance(m, RAB)}


@contextlib.contextmanager
def recorded_kinks(generator, store: dict):
    """Record each RAB's LeakyReLU input (its conv1's output) of the
    forwards inside the block, on the CPU."""
    hooks = [conv.register_forward_hook(
        lambda mod, inp, out, n=n: store.__setitem__(n, out.detach().cpu()))
        for n, conv in _rab_conv1s(generator).items()]
    try:
        yield store
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def aligned_kinks(generator, card: dict, flips: dict):
    """Inside the block, each RAB's LeakyReLU input takes the card's value
    (``card``, from :func:`recorded_kinks`) wherever the two lie on either
    side of zero and both within KINK_EPS of the layer's max: the reference
    then takes the card's branch of the kink there, which changes its
    values by at most 2 KINK_EPS of the max and its gradients' paths not
    at all (the change is a constant).  ``flips`` sums, per layer, the
    count of such elements and keeps the largest |card - reference|
    adopted."""
    def align(mod, inp, out, n):
        theirs = card[n].to(out)
        band = KINK_EPS * out.abs().max()
        flip = (((theirs > 0) != (out > 0))
                & (out.abs() <= band) & (theirs.abs() <= band))
        adopted = float(((theirs - out).abs() * flip).max().detach())
        count, most = flips.get(n, (0, 0.0))
        flips[n] = (count + int(flip.sum()), max(most, adopted))
        return out + ((theirs - out) * flip).detach()

    hooks = [conv.register_forward_hook(
        lambda mod, inp, out, n=n: align(mod, inp, out, n))
        for n, conv in _rab_conv1s(generator).items()]
    try:
        yield flips
    finally:
        for h in hooks:
            h.remove()


def _cpu_step(batch, float64: bool, rab_tail: str, check: dict,
              card_kinks: dict | None = None):
    """The CPU step; with ``card_kinks`` (the card's RAB LeakyReLU inputs
    of its step) it takes the card's branch at each kink they straddle
    (:func:`aligned_kinks`), and ``trainer.kink_flips`` counts them."""
    trainer = _fan_in_trainer("cpu", float64, rab_tail, check)
    trainer.kink_flips = {}
    align = (aligned_kinks(trainer.generator, card_kinks, trainer.kink_flips)
             if card_kinks is not None else contextlib.nullcontext())
    t0 = time.perf_counter()
    with align:
        metrics = trainer.train_step(batch, torch.Generator().manual_seed(7))
    return trainer, metrics, time.perf_counter() - t0


def _d_sensitivity(batch, size: float, check: dict) -> tuple:
    """(worst |change| over max |grad|, its name) of the card's D gradients
    when every pixel of the unfused sr moves by +-``size`` of sr's largest,
    the sign drawn from a seed: two D steps from the same weights, batch and
    penalty weights, which differ in that perturbation alone."""
    grads = []
    for perturbed in (False, True):
        trainer = _fan_in_trainer("cuda", check=check)
        hr = trainer._to_device(batch["hr"])
        sr = trainer._eval_sr(batch["lr"])
        if perturbed:
            sign = torch.randint(0, 2, sr.shape,
                                 generator=torch.Generator().manual_seed(5))
            sr = sr + (sign * 2 - 1).to(sr) * size * sr.abs().max()
        trainer._d_step(hr, sr, _check_alpha(trainer, hr), {})
        grads.append({n: p.grad.cpu() for n, p in
                      trainer.discriminator.named_parameters()
                      if n not in zero_by_math(trainer.discriminator)})
    return max((_max_rel(g, grads[0][n]), n) for n, g in grads[1].items())


def _plain_attention(q, k, v, with_lse: bool = False):
    out = sgam_flash.position_attention_plain(q, k, v)
    if not with_lse:
        return out
    with torch.autocast(q.device.type, enabled=False):
        energy = torch.bmm(q.float(), k.float().transpose(1, 2))
    return out, torch.logsumexp(energy, dim=-1)


def _plain_gate_bwd(x, w, g, with_dw: bool = True):
    return spatial_gate.spatial_gate_bwd_plain(x, w, g)


# Each kernel's wrapper, by the module attribute that its registered op's
# CUDA implementation looks up at each call (every caller goes through the
# op, the fused tail's backward too), and the plain version that stands in
# for it in the kernel-free control (kernels_swapped_for_plain).
PLAIN_STAND_INS = (
    (pooling, "avg_max_pool_cuda", pooling.avg_max_pool_plain),
    (spatial_gate, "spatial_gate_cuda",
     lambda x, w, rows=None: spatial_gate.spatial_gate_plain(x, w)),
    (spatial_gate, "spatial_gate_bwd_cuda", _plain_gate_bwd),
    (sgam_flash, "position_attention_cuda", _plain_attention),
    (sgam_flash, "position_attention_bwd_cuda",
     lambda q, k, v, out, dout, lse:
     sgam_flash.position_attention_bwd_plain(q, k, v, dout)),
    (rab_tail, "rab_tail_cuda", rab_tail.rab_tail_plain),
)


@contextlib.contextmanager
def kernels_swapped_for_plain():
    """Every kernel of the port replaced by its plain PyTorch version on
    the card, for the kernel-free control of a gradient check."""
    saved = [(mod, name, getattr(mod, name))
             for mod, name, _ in PLAIN_STAND_INS]
    try:
        for mod, name, plain in PLAIN_STAND_INS:
            setattr(mod, name, plain)
        yield
    finally:
        for mod, name, kernel in saved:
            setattr(mod, name, kernel)


def _kernel_free(rab_tail_mode: str, check: dict, run):
    """``run(trainer)`` on a fresh card trainer with every kernel swapped
    for its plain version; fails if a kernel launched all the same."""
    reset_launches()
    with kernels_swapped_for_plain():
        trainer = _fan_in_trainer("cuda", rab_tail=rab_tail_mode, check=check)
        run(trainer)
        torch.cuda.synchronize()
    launched = {k: n for k, n in read_launches().items() if n}
    if launched:
        fail(f"the kernel-free control launched kernels: {launched}")
    return trainer


def _d_step_from(trainer, batch: dict, sr: torch.Tensor):
    """The trainer's D step on ``sr`` (cast to its dtype and device), with
    the check's penalty weights; returns the trainer."""
    hr = trainer._to_device(batch["hr"])
    trainer._d_step(hr, sr.to(hr), _check_alpha(trainer, hr), {})
    return trainer


def _check_alpha(trainer, hr: torch.Tensor):
    """The check's penalty weights for the images ``hr``, on the trainer's
    device (None without a penalty)."""
    alpha = trainer._penalty_draw(hr.shape[0],
                                  torch.Generator().manual_seed(7))
    return None if alpha is None else alpha.to(trainer.device)


# SRAGAN's gradient check (SRAGAN_CHECK, "kernel_free_control") holds each
# gradient tensor t of the card's step to max(GRAD_TOL[net], CONTROL_FACTOR
# * c(t)), c(t) being the larger reading at t of two float32 steps without
# the port's kernels: the card's own, every kernel swapped for its plain
# version, and the CPU's.  CONTROL_FACTOR is the flagship rule's "twice the
# worst float32 reading".
CONTROL_FACTOR = 2.0


def _grads_against_controls(card, sr, batch, ref, control, rab_tail_mode,
                            check, report, faults) -> None:
    """The gradient report of a check whose float32 steps cannot meet
    GRAD_TOL (SRAGAN's).  G: the card's step against the CPU's float64
    step, beside the two kernel-free float32 steps.  D: the D step from
    the card's own ``sr`` on every side (the card's step, float64, the CPU's
    float32, the card's without kernels), since the D's gradients move by
    parts in 10^2 when sr moves by parts in 10^7; the whole step's D
    readings are printed too.  Each tensor t must stay within
    max(GRAD_TOL[net], CONTROL_FACTOR * c(t)) of max|ref(t)|."""
    model_name = check["model"]
    free = _kernel_free(rab_tail_mode, check, lambda t: t.train_step(
        batch, torch.Generator().manual_seed(7)))
    d_sides = {"card": card, "ref": _d_step_from(
        _fan_in_trainer("cpu", True, rab_tail_mode, check), batch, sr.cpu()),
        "free": _kernel_free(rab_tail_mode, check,
                             lambda t: _d_step_from(t, batch, sr)),
        "control": _d_step_from(
            _fan_in_trainer("cpu", False, rab_tail_mode, check), batch,
            sr.cpu())}
    sides = {"generator": (card, ref, free, control),
             "discriminator": tuple(d_sides[k] for k in
                                    ("card", "ref", "free", "control"))}
    d_whole = [_grad_errors(t.discriminator, ref.discriminator,
                            zero_by_math(ref.discriminator))[0]
               for t in (card, free, control)]
    print(f"{model_name} train step ({rab_tail_mode}) discriminator "
          "gradients of the whole step against float64's, worst of "
          "max|ref|: " + ", ".join(
              f"{side} {n} {e:.3e}" for side, (e, n) in zip(
                  ("card", "card without kernels", "CPU float32"), d_whole)))
    for net, (mine, reference, no_kernels, cpu32) in sides.items():
        model, reference = getattr(mine, net), getattr(reference, net)
        scale = max(float(p.grad.abs().max()) for p in reference.parameters())
        zero = zero_by_math(model)
        zero_worst = max(float(p.grad.abs().max()) / scale
                         for n, p in model.named_parameters() if n in zero)
        errs = {n: e for e, n in _grad_errors(model, reference, zero)}
        free_errs = {n: e for e, n in _grad_errors(
            getattr(no_kernels, net), reference, zero)}
        cpu_errs = {n: e for e, n in _grad_errors(getattr(cpu32, net),
                                                  reference, zero)}
        bar = check["tol"][net]
        allowed = {n: max(bar, CONTROL_FACTOR * max(free_errs[n],
                                                    cpu_errs[n]))
                   for n in errs}
        ratio, at = max((errs[n] / allowed[n], n) for n in errs)
        worst = {side: max((e, n) for n, e in d.items()) for side, d in
                 (("card", errs), ("free", free_errs), ("cpu", cpu_errs))}
        report[net] = {
            "worst": worst["card"][1], "err": worst["card"][0],
            "free_worst": worst["free"][1], "free_err": worst["free"][0],
            "control_worst": worst["cpu"][1], "control_err": worst["cpu"][0],
            "held_at": at, "held_err": errs[at], "allowed": allowed[at],
            "ratio": ratio, "tol": bar, "factor": CONTROL_FACTOR,
            "zero_by_math_worst": zero_worst, "tensors": len(errs)}
        meet = [label for side, label in (("card", "card"), (
            "free", "card without kernels"), ("cpu", "CPU float32"))
            if worst[side][0] <= bar]
        what = ("step" if net == "generator"
                else "D step from the card's sr")
        print(f"{model_name} train step ({rab_tail_mode}) {net} gradients "
              f"of the {what} against float64's, {len(errs)} tensors, "
              "worst of max|ref|: card "
              f"{worst['card'][1]} {worst['card'][0]:.3e}, card without "
              f"kernels {worst['free'][1]} {worst['free'][0]:.3e}, CPU "
              f"float32 {worst['cpu'][1]} {worst['cpu'][0]:.3e}; the fixed "
              f"bar {bar:.0e} met by: {', '.join(meet) or 'none'}; each "
              f"tensor held to max({bar:.0e}, {CONTROL_FACTOR:g} x the "
              "larger kernel-free reading there): worst "
              f"{at} {errs[at]:.3e} of {allowed[at]:.3e} allowed "
              f"({ratio:.2f}); {len(zero)} zero by the math, card's largest "
              f"{zero_worst:.3e} of the network's largest (tol "
              f"{ZERO_TOL:.0e})")
        if not ratio <= 1.0:
            faults.append(f"{net} gradient {at} differs from float64 by "
                          f"{errs[at]:.3e} of max|ref|, over the "
                          f"{allowed[at]:.3e} its kernel-free controls allow")
        if not zero_worst <= ZERO_TOL:
            faults.append(f"a {net} gradient that is zero by the math "
                          f"reaches {zero_worst:.3e} of the largest")


def phase_train_correctness(rab_tail: str, unfused_card=None,
                            check: dict = FLAGSHIP_CHECK) -> dict:
    """One float32 step of the x4 trainer that ``check`` describes (the
    flagship's by default) on the card against the CPU plain path's step in
    float64, from the same weights, batch and penalty weights, with the RAB
    tails unfused or fused on both sides; returns the step's launch counts,
    the gradient report and the card's own sr and D gradients.

    ``unfused_card`` is that last item of the unfused run.  The D's code is
    the same fused or not and the tails reach it through sr alone, so the
    fused run also prints how far its sr and its D gradients lie from the
    unfused card's: what a difference in sr's last bits does to the D's
    gradients, apart from any reference, and beside it what a random
    perturbation of sr of that size does to them (:func:`_d_sensitivity`).

    The step's gradients are ill-conditioned in places (sums that cancel,
    BatchNorm over the penalty's second order), so float32 rounding alone
    moves some of them by parts in 10^3 of their tensor's largest.  The
    reference is therefore float64, and the CPU's own float32 step is the
    control: it must pass the same fixed bound, or the bound says nothing
    about the card.  A check with ``kernel_free_control`` (SRAGAN's, whose
    float32 steps miss that bound) holds each tensor to its kernel-free
    controls instead (:func:`_grads_against_controls`)."""
    batch = make_batch(batch=2, seed=1)
    model_name = check["model"]
    card = _fan_in_trainer("cuda", rab_tail=rab_tail, check=check)
    mine = {"sr": card._eval_sr(batch["lr"]).cpu()}
    if check.get("kernel_free_control"):  # keep the sr the D step takes
        d_step = card._d_step

        def d_step_keeping_sr(hr, sr, *args):
            mine["step_sr"] = sr
            return d_step(hr, sr, *args)
        card._d_step = d_step_keeping_sr
    card_kinks = {} if check.get("align_kinks") else None
    reset_launches()
    with (recorded_kinks(card.generator, card_kinks) if card_kinks
          is not None else contextlib.nullcontext()):
        got = card.train_step(batch, torch.Generator().manual_seed(7))
    torch.cuda.synchronize()
    launches = read_launches()
    want_launches = step_launches(card)
    print(f"{model_name} train step launches (batch 2, f32, {rab_tail}): "
          f"{launches}")
    if launches != want_launches:
        fail(f"train step launch counts {launches} differ from the "
             f"module structure's {want_launches}")

    ref, want, ref_s = _cpu_step(batch, True, rab_tail, check, card_kinks)
    if card_kinks is not None:
        flipped = {n: k for n, (k, _) in ref.kink_flips.items() if k}
        adopted = max((a for _, a in ref.kink_flips.values()), default=0.0)
        print(f"{model_name} train step ({rab_tail}): the float64 reference "
              f"takes the card's side of {sum(flipped.values())} LeakyReLU "
              f"kink(s) within {KINK_EPS:.0e} of their layer's max, the "
              f"largest |card - reference| adopted {adopted!r}: {flipped}")
        over = {n: k for n, k in flipped.items() if k > KINK_CAP}
        if over:
            fail(f"more than {KINK_CAP} kinks a layer differ in sign between "
                 f"the card and the float64 reference: {over}")
    control, control_metrics, control_s = _cpu_step(batch, False, rab_tail,
                                                    check)
    for key in ("loss_G", "loss_D", "pixel", "content", "adv_g"):
        w = float(want[key])
        for side, metrics in (("card", got), ("CPU float32", control_metrics)):
            g = float(metrics[key])
            if not abs(g - w) <= LOSS_TOL * max(abs(w), 1e-2):
                fail(f"train step {key}: {side} {g!r} vs CPU float64 {w!r}")
    print(f"{model_name} train step losses, card / CPU float32 / CPU "
          "float64: " + ", ".join(f"{k} {float(got[k]):.8e} / "
                      f"{float(control_metrics[k]):.8e} / {float(want[k]):.8e}"
                      for k in ("loss_G", "loss_D")))
    report, faults = {}, []
    nets = ("generator", "discriminator")
    if check.get("kernel_free_control"):
        _grads_against_controls(card, mine.pop("step_sr"), batch, ref,
                                control, rab_tail, check, report, faults)
        nets = ()
    for net in nets:
        model, reference = getattr(card, net), getattr(ref, net)
        scale = max(float(p.grad.abs().max()) for p in reference.parameters())
        zero = zero_by_math(model)
        zero_worst = max(float(p.grad.abs().max()) / scale
                         for n, p in model.named_parameters() if n in zero)
        errs = _grad_errors(model, reference, zero)
        ctrl = _grad_errors(getattr(control, net), reference, zero)
        tol = check["tol"][net]
        control_at_worst = dict((n, e) for e, n in ctrl)[errs[0][1]]
        report[net] = {"worst": errs[0][1], "err": errs[0][0],
                       "control_worst": ctrl[0][1], "control_err": ctrl[0][0],
                       "control_at_worst": control_at_worst,
                       "tol": tol, "zero_by_math_worst": zero_worst,
                       "tensors": len(errs)}
        print(f"{model_name} train step ({rab_tail}) {net} gradients "
              "against the CPU float64 step: "
              f"{len(errs)} tensors; card worst of max|ref|: "
              + ", ".join(f"{n} {e:.3e}" for e, n in errs[:4])
              + "; CPU float32 (control) worst: "
              + ", ".join(f"{n} {e:.3e}" for e, n in ctrl[:2])
              + f", at {errs[0][1]} {control_at_worst:.3e}"
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
    sgam = {key: p for key, p in card.generator.named_parameters()
            if key.endswith(("sa.query_conv.weight", "sa.gamma"))}
    if not sgam:
        faults.append("the generator has no SGAM parameter to check")
    for key, p in sgam.items():
        if not float(p.grad.abs().max()) > 0:
            faults.append(f"the SGAM gradient {key} is zero")
    print(f"CPU steps took {ref_s:.1f} s (float64) and {control_s:.1f} s "
          "(float32)")
    mine["d_grads"] = {n: p.grad.cpu() for n, p in
                       card.discriminator.named_parameters()}
    if unfused_card is not None:
        sr_err = _max_rel(mine["sr"], unfused_card["sr"])
        skip = zero_by_math(card.discriminator)
        moved = sorted(((_max_rel(g, unfused_card["d_grads"][n]), n)
                        for n, g in mine["d_grads"].items() if n not in skip),
                       reverse=True)
        worst = report["discriminator"]["worst"]
        report["vs_unfused_card"] = {
            "sr": sr_err, "d_worst": moved[0][1], "d_err": moved[0][0],
            "d_at_worst": dict((n, e) for e, n in moved)[worst]}
        print(f"fused card against unfused card: sr {sr_err:.3e} of its "
              "max; D gradients of max|unfused|, worst: "
              + ", ".join(f"{n} {e:.3e}" for e, n in moved[:3])
              + f", at {worst} {report['vs_unfused_card']['d_at_worst']:.3e}")
        noise_err, noise_at = _d_sensitivity(batch, sr_err, check)
        report["vs_unfused_card"].update(noise_err=noise_err,
                                         noise_at=noise_at)
        print(f"unfused card, sr moved by +-{sr_err:.3e} of its max at "
              f"random: D gradients move by {noise_err:.3e} of their max "
              f"({noise_at})")
        if not sr_err <= SLICE_TOL:
            faults.append(f"the fused sr is {sr_err:.3e} of its max off the "
                          "unfused card's")
    if faults:
        fail("; ".join(faults))
    return {"launches": launches, "grad_check": report, "card": mine}


def phase_validation_batch() -> dict:
    """One batch of the validation sweep as ``cli train`` runs it (one
    216^2 synthetic test image, so the fused tail sees (1, 64, 54, 54) and
    the SGAM B = 1): the fused trainer's sr against the unfused trainer's
    on the card, from the same weights, in float32 (SLICE_TOL) and in the
    mixed precision (PSNR against the float32 sr no more than 3 dB behind
    the unfused one's), with the forward's exact launch counts and finite
    metrics."""
    out, ref = {}, None
    for precision in ("f32", "bf16"):
        srs = {}
        for rab in ("unfused", "fused"):
            trainer = make_trainer(precision, rab_tail=rab)
            data = trainer.cfg.data
            data.synthetic = True
            batch = next(iter(DataLoader(
                build_test_dataset(data, trainer.cfg.scale),
                data.test_batch_size, shuffle=False, drop_last=False,
                num_workers=1)))
            if batch["lr"].shape != (1, 54, 54, 3):
                fail(f"validation batch lr is {batch['lr'].shape}")
            reset_launches()
            srs[rab] = trainer._eval_sr(batch["lr"]).cpu().numpy()
            launches = read_launches()
            if launches != forward_launches(trainer.generator):
                fail(f"validation forward ({precision}, {rab}) launches "
                     f"{launches} differ from the path's "
                     f"{forward_launches(trainer.generator)}")
            metrics = {k: float(v) for k, v in
                       trainer._eval_step(batch).items()}
            if not np.isfinite(list(metrics.values())).all():
                fail(f"validation metrics ({precision}, {rab}): {metrics}")
            out[f"{precision}_{rab}_psnr"] = metrics["psnr"]
            del trainer
        if precision == "f32":
            ref = srs["unfused"]
            err = float(np.abs(srs["fused"] - ref).max())
            bound = SLICE_TOL * float(np.abs(ref).max())
            out["f32_max_abs_err"] = err
            print(f"validation batch 1 x 54^2, f32: fused vs unfused sr on "
                  f"the card max|d| {err:.3e} <= {bound:.3e}; PSNR to hr "
                  f"{out['f32_fused_psnr']:.4f} / "
                  f"{out['f32_unfused_psnr']:.4f} dB")
            if not err <= bound:
                fail("the fused validation batch disagrees with the unfused")
        else:
            db = {rab: psnr(srs[rab], ref) for rab in srs}
            out["bf16_vs_f32_db"] = db
            print(f"validation batch 1 x 54^2, bf16 vs the f32 sr: PSNR "
                  f"{db['fused']:.2f} dB fused, {db['unfused']:.2f} dB "
                  f"unfused; PSNR to hr {out['bf16_fused_psnr']:.4f} / "
                  f"{out['bf16_unfused_psnr']:.4f} dB")
            if not db["fused"] >= db["unfused"] - 3.0:
                fail("the fused bf16 validation batch is further than 3 dB "
                     "behind the unfused one")
    return out


def phase_train_timing(smi: str, model: str = "sradsgan") -> dict:
    """ms per step and MP/s of HR output at batch 16, float32 and mixed
    precision, RAB tails unfused and fused in turn, for ``model``'s x4
    trainer; returns the timings and each variant's first-step
    launches."""
    batch = make_batch()
    mpix = 16 * 216 * 216 / 1e6
    out = {}
    what = "" if model == "sradsgan" else f"{model} "
    for precision in ("f32", "bf16"):
        for rab in ("unfused", "fused"):
            label = precision if rab == "unfused" else f"fused_{precision}"
            trainer = make_trainer(precision, rab_tail=rab, model=model)
            reset_launches()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            launches = read_launches()
            if launches != step_launches(trainer):
                fail(f"{label} train step launches {launches} differ from "
                     f"{step_launches(trainer)}")
            out[f"launches_{label}"] = launches
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
                fail(f"{label} train step losses are not finite: {losses}")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            out[f"{label}_ms_per_step"] = ms
            out[f"{label}_mp_per_s"] = mpix / (ms / 1e3)
            out[f"{label}_peak_gib"] = peak
            print(f"{what}train step batch 16 x 54^2 -> 216^2 {label}: "
                  f"{ms:.2f} ms/step, {mpix / (ms / 1e3):.3f} MP/s of HR "
                  f"output, peak {peak:.2f} GiB; losses {losses} [{smi}]")
            del trainer, metrics
    return out


class _Tee(io.TextIOBase):
    """Pass writes on to a stream and keep a copy."""

    def __init__(self, stream):
        self.stream = stream
        self.lines = io.StringIO()

    def write(self, text):
        self.lines.write(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


CLI_EPOCHS = 2


def phase_cli_train(smi: str) -> dict:
    """The training entry point at its default sizes, fused, for two
    epochs of the synthetic set and their validation sweeps (the second
    epoch reaches step 50, the first line of loss_log.txt)."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as save_dir:
        argv = ["train", "--model", "sradsgan", "--scale", "4", "--data",
                "synthetic", "--model-kwargs", '{"rab_tail": "fused"}',
                "--no-final-eval", "--epochs", str(CLI_EPOCHS), "--save-dir",
                save_dir]
        print("python -m sradsgan_tpu_torch.cli " + " ".join(argv))
        tee = _Tee(sys.stdout)
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        if rc != 0:
            fail(f"cli train exited with {rc}")
        run_dir = os.path.join(save_dir, "SRADSGAN_x4")
        for name in ("ckpt_best.pt", f"ckpt_epoch_{CLI_EPOCHS - 1}.pt",
                     "logs/loss_log.txt", "logs/val_log.txt"):
            path = os.path.join(run_dir, name)
            if not (os.path.exists(path) and os.path.getsize(path) > 0):
                fail(f"cli train did not write {name}")
        with open(os.path.join(run_dir, "logs/val_log.txt")) as f:
            val_lines = len(f.readlines())
    result = json.loads(tee.lines.getvalue().strip().splitlines()[-1])
    final, feed = result["final"], result["feed"]
    if (set(final) != {"psnr", "ssim", "ergas", "bc_psnr", "bc_ssim"}
            or not np.isfinite(list(final.values())).all()):
        fail(f"cli train's final metrics are not finite: {final}")
    if val_lines != CLI_EPOCHS:
        fail(f"val_log.txt has {val_lines} lines for {CLI_EPOCHS} epochs")
    # the loop's structure at the default sizes: 512 images in batches of
    # 16, a validation sweep of 64 images one at a time after each epoch;
    # the host calls the kernels in the steps it takes eagerly or captures
    # into a CUDA graph, the graph launches them in the steps it replays
    kinds = result["steps"]
    if sum(kinds.values()) != CLI_EPOCHS * (512 // 16):
        fail(f"cli train took steps {kinds}, not {CLI_EPOCHS * (512 // 16)}")
    steps = kinds["eager"] + kinds["captured"]
    val_forwards = CLI_EPOCHS * 64
    gates = 12 * (3 + 1)
    expected = {"avg_max_pool": 4 * steps, "spatial_gate": 4 * steps,
                "position_attention": steps + val_forwards,
                "spatial_gate_bwd": (gates + 5) * steps,
                "position_attention_bwd": steps,
                "rab_tail": gates * (steps + val_forwards)}
    print(f"cli train launches: {launches}")
    if launches != expected:
        fail(f"cli train launch counts {launches} differ from the loop's "
             f"{expected}")
    print(f"cli train: {CLI_EPOCHS} epochs of {512 // 16} steps ({kinds}) "
          f"with their validation sweeps in {seconds:.1f} s; last epoch "
          f"{feed['epoch_s']:.2f} s, of which the loop waited on the data "
          f"feed {feed['feed_wait_s']:.3f} s (share "
          f"{feed['feed_share']:.4f}); final {final} [{smi}]")
    return {"launches": launches, "seconds": seconds, "final": final,
            "feed": feed}


EVAL_IMAGES = 64  # the synthetic test set at the default sizes
EVAL_BATCH = 8
# the table's rows, card against the CPU plain path, per image
ROW_BARS = {"psnr": ("abs", 1e-3), "ssim": ("abs", 1e-5),
            "ergas": ("rel", 1e-4), "lpips": ("rel", 1e-4),
            "mse": ("rel", 2.3e-4)}


class _FirstImages:
    """The first ``n`` images of a dataset, as a dataset."""

    def __init__(self, dataset, n: int):
        self.dataset, self.n = dataset, n

    def __len__(self):
        return self.n

    def load(self, index: int, rng=None):
        return self.dataset.load(index, rng)


def _row_faults(got: dict, want: dict, what: str) -> list:
    faults = []
    for key, (kind, bar) in ROW_BARS.items():
        g, w = got[key], want[key]
        err = abs(g - w) if kind == "abs" else abs(g - w) / abs(w)
        if not err <= bar:
            faults.append(f"{what} {key}: card {g!r}, CPU {w!r} ({kind} "
                          f"{err:.3e} > {bar:.0e})")
    return faults


def _cli_run(argv: list, smi: str) -> tuple:
    """``cli.main(argv)`` in this process: its stdout lines and launches."""
    print("python -m sradsgan_tpu_torch.cli " + " ".join(argv))
    tee = _Tee(sys.stdout)
    reset_launches()
    with contextlib.redirect_stdout(tee):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    launches = read_launches()
    if rc != 0:
        fail(f"cli {argv[0]} exited with {rc}")
    return tee.lines.getvalue().strip().splitlines(), launches


def _check_table_lines(lines: list, what: str) -> None:
    """The by-class text table: the five columns' header, then "all" and
    "Total" with finite numbers."""
    header = ["class", "PSNR", "SSIM", "ERGAS", "bcPSNR", "bcSSIM"]
    at = [i for i, line in enumerate(lines) if line.split() == header]
    rows = [line.split() for line in lines[at[-1] + 1:at[-1] + 3]] if at \
        else []
    if (not at or [r[0] for r in rows] != ["all", "Total"]
            or not np.isfinite([float(v) for r in rows for v in r[1:]]).all()):
        fail(f"{what} did not print the by-class table: {lines[-4:]}")


def phase_eval_protocol(smi: str) -> dict:
    """The evaluation protocol on the card: ``mfe_new_validate_by_class``
    over the synthetic test set (64 images, 216^2 HR, bilinear 54^2 LR, in
    batches of 8) for the full-width x4 generator (seeded fan-in weights,
    gains 0.5) with AlexNet LPIPS (seeded trunk: lpips*), unfused and
    fused: exact launch counts per sweep, the table's rows finite, and the
    sweep's seconds split into the device forward, LPIPS and host scoring.
    The first batch also goes through the CPU plain path: the card's SR
    within SLICE_TOL of max|ref|, its LPIPS within 1e-4 relative and the
    rows within ROW_BARS (TF32 off).  Then ``cli validate-by-class`` and
    ``cli train`` with its final table, both with ``--lpips``, at 64^2."""
    model = create_generator("sradsgan", 4, seed=0)
    fan_in_init(model, seed=5)
    with torch.no_grad():
        model.GAB_UP.ca.gamma.fill_(0.5)
        model.GAB_UP.sa.gamma.fill_(0.5)
    cpu_model = copy.deepcopy(model).eval()
    fused = create_generator("sradsgan", 4, rab_tail="fused")
    fused.load_state_dict(model.state_dict())
    data = DataConfig(synthetic=True)
    if len(build_test_dataset(data, 4)) != EVAL_IMAGES:
        fail("the synthetic test set is not 64 images")
    lp = lpips_fn("alex")
    print(f"LPIPS trunk calibrated: {lpips_is_calibrated('alex')} (lpips* "
          "without SRADSGAN_TPU_ALEXNET_NPZ)")

    # the first batch on the CPU plain path: SR, LPIPS and the rows
    first = _FirstImages(build_test_dataset(data, 4), EVAL_BATCH)
    batch = next(iter(DataLoader(first, EVAL_BATCH, shuffle=False,
                                 drop_last=False, num_workers=4)))
    t0 = time.perf_counter()
    cpu_sr = Evaluator(cpu_model, 4, device="cpu").super_resolve(batch["lr"])
    cpu_lpips = lp.batched(*(torch.from_numpy(
        np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
        for a in (cpu_sr, batch["hr"]))).numpy()
    cpu_rows = [dict(_score_pair(cpu_sr[i], batch["hr"][i], 4),
                     lpips=float(cpu_lpips[i])) for i in range(EVAL_BATCH)]
    cpu_s = time.perf_counter() - t0

    out, paths = {"cpu_first_batch_s": cpu_s}, {}
    for rab, gen in (("unfused", model), ("fused", fused)):
        ev = Evaluator(gen, 4, lp, EVAL_BATCH, device="cuda")
        sr = ev.super_resolve(batch["lr"])
        sr_err = float(np.abs(sr - cpu_sr).max())
        sr_bound = SLICE_TOL * float(np.abs(cpu_sr).max())
        rows = ev.run(first)["all"]["sr"]
        lp_err = max(abs(r["lpips"] - c["lpips"]) / abs(c["lpips"])
                     for r, c in zip(rows, cpu_rows))
        faults = [f for i, (r, c) in enumerate(zip(rows, cpu_rows))
                  for f in _row_faults(r, c, f"{rab} image {i}")]
        print(f"eval first batch {rab} (8 x 54^2 -> 216^2, f32): SR max|d| "
              f"{sr_err:.3e} <= {sr_bound:.3e}; LPIPS rel {lp_err:.3e} <= "
              f"1e-4; rows within {ROW_BARS} ({len(faults)} faults); CPU "
              f"plain path took {cpu_s:.1f} s")
        if not sr_err <= sr_bound:
            faults.append(f"{rab} SR off the CPU plain path by {sr_err:.3e}")
        if not lp_err <= 1e-4:
            faults.append(f"{rab} LPIPS off the CPU's by {lp_err:.3e}")
        if faults:
            fail("; ".join(faults))

        stats = {}
        reset_launches()
        table = mfe_new_validate_by_class(
            gen, data, 4, lpips_fn=lp, batch_size=EVAL_BATCH, device="cuda",
            stats=stats)
        torch.cuda.synchronize()
        launches = read_launches()
        want = forward_launches(gen, forwards=EVAL_IMAGES // EVAL_BATCH)
        print(f"eval sweep {rab} launches: {launches}")
        if launches != want:
            fail(f"eval sweep ({rab}) launches {launches} differ from the "
                 f"path's {want}")
        values = [v for row in table.values() for side in row.values()
                  for v in side.values()]
        if (list(table) != ["all", "Total"] or stats["images"] != EVAL_IMAGES
                or set(table["Total"]["sr"]) != set(ROW_BARS)
                or not np.isfinite(values).all()):
            fail(f"eval sweep ({rab}) table {dict(table)}, stats {stats}")
        host = stats["score"] + stats["feed"]
        print(format_by_class_table(table))
        print(f"eval sweep {rab}: {EVAL_IMAGES} images in {stats['wall']:.2f} "
              f"s, {EVAL_IMAGES / stats['wall']:.2f} images/s, "
              f"{stats['wall'] / EVAL_IMAGES:.4f} s/image; device forward "
              f"{stats['forward']:.3f} s, LPIPS {stats['lpips']:.3f} s (CUDA "
              f"events, stream spans), host scoring {stats['score']:.3f} s, "
              f"host waiting on the feed {stats['feed']:.3f} s; host share "
              f"{host / stats['wall']:.4f}; Total {table['Total']['sr']} "
              f"[{smi}]")
        out[rab] = dict(stats, sr_max_abs_err=sr_err, lpips_max_rel_err=lp_err,
                        images_per_s=EVAL_IMAGES / stats["wall"],
                        host_share=host / stats["wall"])
        paths[f"eval_sweep_{rab}"] = launches
        del ev

    with tempfile.TemporaryDirectory() as save_dir:
        common = ["--scale", "4", "--data", "synthetic", "--crop-size", "64",
                  "--lpips"]
        lines, launches = _cli_run(
            ["validate-by-class"] + common
            + ["--model-kwargs", '{"rab_tail": "fused"}', "--save-dir",
               os.path.join(save_dir, "validate")], smi)
        _check_table_lines(lines, "cli validate-by-class")
        csv = os.path.join(save_dir, "validate", "SRADSGAN_x4",
                           "by_class_x4.csv")
        with open(csv) as f:
            columns = f.readline().strip().split(",")
        if "sr_lpips" not in columns or "bc_lpips" not in columns:
            fail(f"by_class_x4.csv columns {columns}")
        forwards = EVAL_IMAGES // EVAL_BATCH
        gates = 12 * (3 + 1)
        want = {"avg_max_pool": 0, "spatial_gate": 0,
                "position_attention": forwards, "spatial_gate_bwd": 0,
                "position_attention_bwd": 0, "rab_tail": gates * forwards}
        if launches != want:
            fail(f"cli validate-by-class launches {launches} differ from "
                 f"{want}")
        paths["cli_validate_by_class_fused"] = launches

        steps = 2
        lines, launches = _cli_run(
            ["train", "--steps", str(steps), "--batch-size", "4"] + common
            + ["--save-dir", os.path.join(save_dir, "train")], smi)
        _check_table_lines(lines, "cli train")
        # the steps (as step_launches counts them), then the final table's
        # forwards; --steps ends training before any validation sweep
        want = {"avg_max_pool": steps * (gates + 4) + forwards * gates,
                "spatial_gate": steps * (gates + 4) + forwards * gates,
                "position_attention": steps + forwards,
                "spatial_gate_bwd": steps * (gates + 5),
                "position_attention_bwd": steps, "rab_tail": 0}
        if launches != want:
            fail(f"cli train with its final table launches {launches} "
                 f"differ from {want}")
        paths["cli_train_final_table"] = launches
    print(f"cli validate-by-class and cli train (2 steps, the final table) "
          f"at 64^2 -> their tables, LPIPS columns in the CSV [{smi}]")
    out["launches_by_path"] = paths
    return out


# The model zoo (phase_model_zoo): the seven generators beside the
# flagship, at their published widths and depths (the JAX defaults).
ZOO = ("edsr", "srgan", "drcan", "dssr", "sragan", "ndsrgan", "amssrn")
ZOO_GAN_STEPS = ("srgan", "drcan", "ndsrgan")
# SRAGAN's step at full width and depth, from the module structure (72
# tails, the CBAM D, one PAM): checked against the launches themselves.
SRAGAN_STEP_LAUNCHES = {
    "unfused": {"avg_max_pool": 76, "spatial_gate": 76,
                "position_attention": 1, "spatial_gate_bwd": 77,
                "position_attention_bwd": 1, "rab_tail": 0},
    "fused": {"avg_max_pool": 4, "spatial_gate": 4, "position_attention": 1,
              "spatial_gate_bwd": 77, "position_attention_bwd": 1,
              "rab_tail": 72}}
# SRAGAN's gradient check: full width, 3 of the 12 groups (which bounds the
# CPU's float64 step), both attention gains 0.5 as make_trainer sets them,
# the flagship's fixed bars.  No float32 step of SRAGAN meets those bars,
# with or without the port's kernels: its BatchNorms, the LeakyReLU kinks
# right after them and the CGAM's saturated softmax amplify rounding (the
# D's gradients move by parts in 10^2 of their largest when sr moves by
# parts in 10^7 of its own, _d_sensitivity).  So each tensor is held to
# max(bar, CONTROL_FACTOR x the larger reading there of the card's step
# without kernels and the CPU's float32 step), the D's on its step from
# the card's own sr (_grads_against_controls).
SRAGAN_CHECK = {"model": "sragan", "model_kwargs": {"n_groups": 3},
                "gains": {}, "tol": GRAD_TOL, "kernel_free_control": True}
# cli train at small widths (SRAGAN at its width, the kernels' own, and
# one group of two blocks, fused)
ZOO_CLI_KWARGS = {
    "edsr": {"base_filters": 16, "num_residuals": 2},
    "srgan": {"base_filters": 16, "num_residuals": 2},
    "drcan": {"n_feats": 16, "n_resgroups": 1, "n_resblocks": 2},
    "dssr": {"n_feats": 16, "n_groups": 1, "n_blocks": 2},
    "sragan": {"n_groups": 1, "n_blocks": 2, "rab_tail": "fused"},
    "ndsrgan": {"nf": 16, "nc": 8, "n_dcrdb": 1},
    "amssrn": {"n_feats": 16, "n_blocks": 2},
    "hat": {"embed_dim": 24, "depths": [2], "num_heads": [2]},
}


def zoo_init(model: torch.nn.Module, seed: int) -> None:
    """:func:`fan_in_init`, then BatchNorm scales uniform(0.5, 1.5), shifts
    normal(0, 0.05), running means normal(0, 0.1) and variances uniform(0.5,
    1.5), and every gain ``gamma`` 0.5: no zero-init gain or output conv
    (AMSSRN's non-local ``W`` is a conv) stays zero."""
    fan_in_init(model, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.05, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
        for name, p in model.named_parameters():
            if name.rpartition(".")[2] == "gamma":
                p.fill_(0.5)


def _zoo_forward(name: str, batch: np.ndarray, smi: str, paths: dict, *,
                 model_kwargs: dict | None = None, fused: bool = False,
                 label: str | None = None, path_key: str | None = None,
                 expect: dict | None = None) -> dict:
    """One generator at x4 (``model_kwargs`` its arguments): a batch of four
    54^2 requests on the card in float32 (its exact launches, and where
    given ``expect``'s per tail), the first image against the CPU plain
    path, the bf16 output against the float32 one as a PSNR, and the
    request's latency in both types; with ``fused`` also the fused tails
    from the same weights against the unfused output.  The launches go into
    ``paths`` as ``path_key`` and ``path_key``_fused."""
    kwargs = model_kwargs or {}
    label = label or f"zoo {name}"
    model = create_generator(name, 4, seed=0, **kwargs)
    zoo_init(model, seed=5)
    model.eval()
    state = copy.deepcopy(model.state_dict()) if fused else None
    t0 = time.perf_counter()
    ref = forward_numpy(model, batch[:1], "cpu")
    cpu_s = time.perf_counter() - t0

    def serve(net, rab_tail):
        pred = Predictor(net, 4)  # the model moves to the card
        reset_launches()
        out = pred(batch)
        torch.cuda.synchronize()
        launches = read_launches()
        want = forward_launches(net)
        if launches != want or (expect and expect[rab_tail] != want):
            fail(f"{label} {rab_tail} forward launches {launches}, the "
                 f"module structure's {want}, the table's "
                 f"{expect and expect[rab_tail]}")
        if path_key:
            paths[path_key + ("" if rab_tail == "unfused" else "_fused")] = (
                launches)
        return pred, out, launches

    pred, got, launches = serve(model, "unfused")
    err = float(np.abs(got[:1] - ref).max())
    bound = SLICE_TOL * float(np.abs(ref).max())
    if got.shape != (4, 216, 216, 3) or not np.isfinite(got).all():
        fail(f"{label} output {got.shape}, finite={np.isfinite(got).all()}")
    pred_bf16 = Predictor(model, 4, dtype=torch.bfloat16)
    out_bf16 = pred_bf16(batch)
    if not np.isfinite(out_bf16).all():
        fail(f"{label} bf16 output is not finite")
    row = {"max_abs_err": err, "bound": bound, "cpu_s": cpu_s,
           "psnr_bf16_vs_f32_db": psnr(out_bf16, got),
           "f32_ms": latency_ms(pred, batch, iters=5),
           "bf16_ms": latency_ms(pred_bf16, batch, iters=5),
           "params_m": sum(p.numel() for p in model.parameters()) / 1e6}
    print(f"{label} x4, batch 4 x 54^2 -> 216^2 ({row['params_m']:.2f} M "
          f"parameters): card f32 vs CPU plain path (1 image) max|d| "
          f"{err:.3e} <= {bound:.3e}; bf16 vs f32 PSNR "
          f"{row['psnr_bf16_vs_f32_db']:.2f} dB; {row['f32_ms']:.2f} ms f32, "
          f"{row['bf16_ms']:.2f} ms bf16 a request; launches {launches}; CPU "
          f"took {cpu_s:.1f} s [{smi}]")
    if not err <= bound:
        fail(f"{label}: the card's output disagrees with the CPU plain path")
    del pred, pred_bf16
    if fused:
        net = create_generator(name, 4, rab_tail="fused", **kwargs)
        net.load_state_dict(state)  # strict: the same tree
        fused_pred, fused_out, fused_launches = serve(net, "fused")
        fused_err = float(np.abs(fused_out - got).max())
        fused_bound = SLICE_TOL * float(np.abs(got).max())
        row.update(fused_max_abs_err=fused_err,
                   fused_f32_ms=latency_ms(fused_pred, batch, iters=5))
        print(f"{label} fused vs unfused on the card (4 x 54^2, f32): "
              f"max|d| {fused_err:.3e} <= {fused_bound:.3e}; "
              f"{row['fused_f32_ms']:.2f} ms a request; launches "
              f"{fused_launches} [{smi}]")
        if not fused_err <= fused_bound:
            fail(f"{label}: the fused forward disagrees with the unfused one")
    return row


def _zoo_gan_step(name: str, smi: str, *, precision: str = "bf16",
                  rab_tail: str = "unfused", model_kwargs: dict | None = None,
                  steps: int = 3, median: bool = False,
                  label: str | None = None) -> dict:
    """One ``precision`` step of ``name``'s x4 trainer at full width, batch
    16, its launches exact, then ``steps`` timed ones: finite losses, ms per
    step, the mean over the steps or with ``median`` the median of steps
    each closed by reading its losses."""
    label = label or f"zoo {name}"
    trainer = make_trainer(precision, rab_tail=rab_tail, model=name,
                           **(model_kwargs or {}))
    batch = make_batch()
    reset_launches()
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != step_launches(trainer):
        fail(f"{label} {precision} {rab_tail} step launches {launches} "
             f"differ from {step_launches(trainer)}")
    times = []
    t_all = time.perf_counter()
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        if median:
            losses = {k: float(v) for k, v in metrics.items()}  # waits
        times.append((time.perf_counter() - t0) * 1e3)
    if median:
        ms = float(np.median(times))
    else:
        losses = {k: float(v) for k, v in metrics.items()}  # waits
        ms = (time.perf_counter() - t_all) / steps * 1e3
    mpix = 16 * 216 * 216 / 1e6
    print(f"{label} train step batch 16 x 54^2 -> 216^2 {precision} "
          f"{rab_tail} ({trainer.cfg.gan.gan_type}): {ms:.2f} ms/step"
          f"{' (median)' if median else ''}, {mpix / (ms / 1e3):.3f} MP/s; "
          f"launches {launches}; losses {losses} [{smi}]")
    if not np.isfinite(list(losses.values())).all():
        fail(f"{label} {precision} step losses are not finite: {losses}")
    return {"ms_per_step": ms, "mp_per_s": mpix / (ms / 1e3),
            "losses": losses, "launches": launches}


def _zoo_cli_train(name: str, save_dir: str, smi: str) -> dict:
    """``cli train --model name`` for two steps at small widths."""
    kwargs = ZOO_CLI_KWARGS[name]
    argv = ["train", "--model", name, "--scale", "4", "--data", "synthetic",
            "--steps", "2", "--no-final-eval", "--crop-size", "64",
            "--batch-size", "4", "--model-kwargs", json.dumps(kwargs),
            "--save-dir", save_dir]
    _, launches = _cli_run(argv, smi)
    structure = types.SimpleNamespace(
        generator=create_generator(name, 4, **kwargs),
        discriminator=(create_discriminator(name)
                       if get_spec(name).adversarial else None),
        cfg=config_for_model(name, 4))
    want = {k: 2 * v for k, v in step_launches(structure).items()}
    if launches != want:
        fail(f"cli train --model {name} launches {launches} differ from "
             f"{want}")
    return launches


def phase_model_zoo(smi: str) -> dict:
    """The seven other generators of the zoo, and SRAGAN's x4 WGAN-GP step
    as a second path through the kernels:

    (a) each generator's x4 forward at its published width and depth
    (:func:`_zoo_forward`), SRAGAN also fused;
    (b) SRAGAN's float32 step at batch 2 (SRAGAN_CHECK: full width, 3
    groups) against the CPU float64 step, each gradient tensor within the
    fixed bar or twice the larger reading of two kernel-free float32 steps
    there (the card's without kernels and the CPU's), the D's from the
    card's own sr, unfused and fused (:func:`phase_train_correctness`);
    (c) SRAGAN's full-depth step at batch 16, f32 and mixed precision,
    unfused and fused (:func:`phase_train_timing`), its launches exact
    and equal to SRAGAN_STEP_LAUNCHES;
    (d) one bf16 step each of SRGAN, DRCAN and NDSRGAN at full width;
    (e) ``cli train --model X`` for the seven at small widths."""
    t_start = time.perf_counter()
    paths = {}
    batch = np.random.default_rng(3).random((4, 54, 54, 3),
                                            dtype=np.float32)
    forwards = {}
    for name in ZOO:
        forwards[name] = _zoo_forward(
            name, batch, smi, paths, fused=name == "sragan",
            path_key="sragan_serving" if name == "sragan" else None)
        torch.cuda.empty_cache()

    check = {"unfused": phase_train_correctness("unfused", None,
                                                SRAGAN_CHECK)}
    check["fused"] = phase_train_correctness(
        "fused", check["unfused"].pop("card"), SRAGAN_CHECK)
    check["fused"].pop("card")
    for rab, c in check.items():
        paths[f"sragan_grad_check_{rab}"] = c["launches"]
    torch.cuda.empty_cache()

    timing = phase_train_timing(smi, model="sragan")
    for label in ("f32", "bf16"):
        for rab in ("unfused", "fused"):
            key = label if rab == "unfused" else f"fused_{label}"
            launches = timing.pop(f"launches_{key}")
            if launches != SRAGAN_STEP_LAUNCHES[rab]:
                fail(f"sragan {key} step launches {launches}, not "
                     f"{SRAGAN_STEP_LAUNCHES[rab]}")
            paths[f"sragan_train_{key}"] = launches
    torch.cuda.empty_cache()

    gan_steps = {}
    for name in ZOO_GAN_STEPS:
        gan_steps[name] = _zoo_gan_step(name, smi)
        gan_steps[name].pop("launches")
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as save_dir:
        for name in ZOO:
            launches = _zoo_cli_train(name, os.path.join(save_dir, name), smi)
            if name == "sragan":
                paths["cli_train_sragan_fused"] = launches
    print(f"cli train --model X --steps 2 at small widths returned 0 for "
          f"{', '.join(ZOO)}")
    never = [k for k in KERNELS if not any(
        path[k] for key, path in paths.items() if key.startswith("sragan"))]
    if never:
        fail(f"kernels never launched on SRAGAN's paths: {never}")
    seconds = time.perf_counter() - t_start
    print(f"model zoo phase: {seconds:.1f} s")
    return {"forwards": forwards, "sragan_train": timing,
            "sragan_grad_check": {rab: c["grad_check"]
                                  for rab, c in check.items()},
            "gan_steps": gan_steps, "seconds": seconds,
            "launches_by_path": paths}


# The attention grammar's ablations (phase_attention_grammar): the model,
# its arguments, and the kernel launches of one no-grad forward at full
# width as (K1, K2, K3, K6), unfused and with rab_tail="fused", counted
# from the module code: 36 RAB tails (bla_mode) and 12 group tails
# (rla_mode) in SRADSGAN, 60 block tails and 12 group tails ('CA-SA') in
# SRAGAN; a tail runs K1 for an "Avg|Max" CA, K2 for an "Avg|Max" SA, and
# K6 in place of both where it is fused ('CA-SA', "Avg|Max", the conv); the
# global attention runs K3 where its mode holds an SA.
GRAMMAR_CASES = {
    "g_sa_ca": {"model": "sradsgan", "model_kwargs": {"bla_mode": "SA-CA"},
                "forward": {"unfused": (48, 48, 1, 0),
                            "fused": (36, 36, 1, 12)}},
    "g_parallel": {"model": "sradsgan", "model_kwargs": {
        "rla_mode": "CA|SA", "bla_mode": "CA|SA", "ga_mode": "CA|SA"},
        "forward": {"unfused": (48, 48, 1, 0), "fused": (48, 48, 1, 0)}},
    "g_single": {"model": "sradsgan", "model_kwargs": {
        "bla_mode": "CA", "rla_mode": "SA", "ga_mode": "SA"},
        "forward": {"unfused": (36, 12, 1, 0), "fused": (36, 12, 1, 0)}},
    "g_noconv": {"model": "sradsgan", "model_kwargs": {"add_conv": False},
                 "forward": {"unfused": (48, 48, 1, 0),
                             "fused": (48, 48, 1, 0)}},
    "g_conv_only": {"model": "sradsgan", "model_kwargs": {
        "rla_mode": "", "bla_mode": "", "ga_mode": "CA"},
        "forward": {"unfused": (0, 0, 0, 0), "fused": (0, 0, 0, 0)}},
    "g_avg": {"model": "sradsgan", "model_kwargs": {"pool_mode": "Avg"},
              "forward": {"unfused": (0, 0, 1, 0), "fused": (0, 0, 1, 0)}},
    "g_max": {"model": "sradsgan", "model_kwargs": {"pool_mode": "Max"},
              "forward": {"unfused": (0, 0, 1, 0), "fused": (0, 0, 1, 0)}},
    "sragan_ga_sa_ca": {"model": "sragan", "model_kwargs": {
        "ga_mode": "SA-CA"},
        "forward": {"unfused": (72, 72, 1, 0), "fused": (0, 0, 1, 72)}},
}
# the cases also stepped fused (those whose fused tails differ from the
# unfused ones, and one where the rule fuses none)
GRAMMAR_FUSED_STEPS = ("g_sa_ca", "g_noconv")
# the cases whose float32 step is held against float64 at phase 5's bars,
# each tensor to max(bar, CONTROL_FACTOR x its kernel-free float32
# readings), as SRAGAN_CHECK: the CPU's own float32 step of g_parallel
# misses the fixed G bar (2.000e-3 of max|ref| at res_groups.11.ca.fc1,
# the card 2.054e-3 there; H100 80GB HBM3, 700 W)
GRAMMAR_GRAD_CHECKS = (("g_parallel", "unfused"), ("g_sa_ca", "fused"))
GRAMMAR_TIMED_STEPS = 5


def grammar_forward(case: str, rab_tail: str) -> dict:
    """GRAMMAR_CASES' forward counts of ``case`` as launch counts."""
    k1, k2, k3, k6 = GRAMMAR_CASES[case]["forward"][rab_tail]
    return {"avg_max_pool": k1, "spatial_gate": k2, "position_attention": k3,
            "spatial_gate_bwd": 0, "position_attention_bwd": 0,
            "rab_tail": k6}


def _grammar_case(case: str, smi: str, batch4: np.ndarray) -> dict:
    """One ablation: (a) its x4 forward (:func:`_zoo_forward`), unfused and
    fused, launches equal to GRAMMAR_CASES' table; (b) its WGAN-GP step at
    batch 16, f32 and mixed precision, fused too for GRAMMAR_FUSED_STEPS
    (:func:`_zoo_gan_step`, the median of GRAMMAR_TIMED_STEPS steps)."""
    spec = GRAMMAR_CASES[case]
    name, kwargs = spec["model"], spec["model_kwargs"]
    label = f"grammar {case} ({name} {kwargs})"
    paths = {}
    row = _zoo_forward(name, batch4, smi, paths, model_kwargs=kwargs,
                       fused=True, label=label,
                       path_key=f"grammar_{case}_forward",
                       expect={rab: grammar_forward(case, rab)
                               for rab in ("unfused", "fused")})
    tails = ("unfused", "fused") if case in GRAMMAR_FUSED_STEPS else (
        "unfused",)
    for precision in ("f32", "bf16"):
        for rab in tails:
            key = precision if rab == "unfused" else f"fused_{precision}"
            step = _zoo_gan_step(name, smi, precision=precision,
                                 rab_tail=rab, model_kwargs=kwargs,
                                 steps=GRAMMAR_TIMED_STEPS, median=True,
                                 label=label)
            paths[f"grammar_{case}" + ("" if key == "f32" else f"_{key}")] = (
                step["launches"])
            row[f"{key}_ms_per_step"] = step["ms_per_step"]
            row[f"{key}_mp_per_s"] = step["mp_per_s"]
    torch.cuda.empty_cache()
    return {"row": row, "paths": paths}


def _library_on_card(smi: str) -> dict:
    """The block library's networks at their published sizes on the card
    against the CPU from the same seeded fan-in weights (zoo_init),
    SLICE_TOL of max|ref| for each output; none may launch a port kernel.
    The SN patch D takes one train-mode forward (its u moves by one power
    iteration on both sides); the patch D with global attention gives its
    WGAN-GP penalty (LOSS_TOL) and the penalty's D-parameter gradients (a
    double backward through the plain CGAM and SGAM at 512; GRAD_TOL's D
    bar, the gradients zero by the math left out) on both sides."""
    from sradsgan_tpu_torch.losses.extra import downscale_loss
    from sradsgan_tpu_torch.models.discriminators import (
        PatchDiscriminator, SNPatchDiscriminator, VGGStyleDiscriminator)
    from sradsgan_tpu_torch.nn.augmented_conv import AugmentedConv
    from sradsgan_tpu_torch.nn.esrgan import RRDBNet, SRResNet
    from sradsgan_tpu_torch.nn.extractors import (ResNet101FeatureExtractor,
                                                  VGGFeatureExtractor)

    rng = np.random.default_rng(11)

    def image(b, size):
        return torch.from_numpy(rng.random((b, 3, size, size),
                                           dtype=np.float32))

    cases = {
        "rrdbnet_nf64_nb23": (lambda: RRDBNet(4), image(1, 32)),
        "srresnet": (lambda: SRResNet(4), image(1, 54)),
        "vgg_style_d_128": (lambda: VGGStyleDiscriminator(128), image(2,
                                                                       128)),
        "aa_conv_relative": (lambda: AugmentedConv(
            64, 64, relative=True, shape=(32, 32)),
            torch.from_numpy(rng.normal(0, 1, (2, 64, 32, 32))
                             .astype(np.float32))),
        "vgg19_conv5_4": (lambda: VGGFeatureExtractor(34), image(1, 224)),
        "resnet101": (lambda: ResNet101FeatureExtractor(), image(1, 224)),
        "sn_patch_d_train": (lambda: SNPatchDiscriminator(), image(2, 96)),
    }
    out, t0 = {}, time.perf_counter()
    reset_launches()
    for label, (make, x) in cases.items():
        net = make()
        zoo_init(net, seed=21)
        train = label.endswith("_train")
        cpu_net = copy.deepcopy(net).train(train)
        card_net = net.to("cuda").train(train)
        with torch.no_grad():
            ref = cpu_net(x)
            got = card_net(x.cuda()).cpu()
        err = _max_rel(got, ref)
        row = {"rel_err": err, "shape": list(got.shape)}
        if train:
            u_err = max(_max_rel(m.u, c.u) for m, c in zip(
                card_net.modules(), cpu_net.modules()) if hasattr(m, "u"))
            row["u_rel_err"] = u_err
            err = max(err, u_err)
        if not (torch.isfinite(got).all() and err <= SLICE_TOL):
            fail(f"library {label}: card vs CPU {err:.3e} of max|ref|")
        out[label] = row
        del net, cpu_net, card_net
    # the global-attention patch D under the penalty, in train mode as the
    # trainer runs it (in eval mode the drawn running statistics leave the
    # input gradient near zero and the penalty at 1)
    d = PatchDiscriminator(use_attention=False, use_global_attention=True,
                           seed=3)
    zoo_init(d, seed=22)
    # zero by the math too: the SGAM's value bias shifts the activations
    # that reach the logits through the last (linear) conv alone, so the
    # penalty's input gradient does not depend on it
    skip = zero_by_math(d) | {n for n, _ in d.named_parameters()
                              if n.endswith("value_conv.bias")}
    real, fake, alpha = image(2, 96), image(2, 96), torch.rand(
        (2, 1, 1, 1), generator=torch.Generator().manual_seed(4))
    sides = {}
    for dev, net in (("cpu", copy.deepcopy(d)), ("cuda", d.to("cuda"))):
        gp = gan_losses.gradient_penalty(net, real.to(dev), fake.to(dev),
                                         alpha.to(dev))
        grads = torch.autograd.grad(gp, list(net.parameters()),
                                    allow_unused=True)
        sides[dev] = (float(gp.detach()), {n: g.cpu() for (n, _), g in zip(
            net.named_parameters(), grads) if g is not None})
    (gp_ref, g_ref), (gp_got, g_got) = sides["cpu"], sides["cuda"]
    errs = sorted(((_max_rel(g_got[n], g), n) for n, g in g_ref.items()
                   if n not in skip), reverse=True)
    worst = errs[0]
    print("library global-attention D penalty gradients, card of CPU, "
          "worst: " + ", ".join(f"{n} {e:.3e}" for e, n in errs[:4]))
    finite = np.isfinite(gp_got) and all(torch.isfinite(g).all()
                                         for g in g_got.values())
    sgam = [n for n in g_got if "query_conv" in n]
    if not (finite and abs(gp_got - gp_ref) <= LOSS_TOL * max(abs(gp_ref),
                                                               1e-2)
            and worst[0] <= GRAD_TOL["discriminator"] and sgam
            and float(g_got[sgam[0]].abs().max()) > 0):
        fail(f"library global-attention D penalty: card {gp_got!r} vs CPU "
             f"{gp_ref!r}, worst gradient {worst}, SGAM grads {sgam}")
    out["patch_d_global_attention_gp"] = {
        "gp": gp_got, "gp_cpu": gp_ref, "grad_worst": worst[1],
        "grad_rel_err": worst[0], "tensors": len(g_got)}
    sr, lr = image(2, 216).cuda(), image(2, 54).cuda()
    out["downscale_loss"] = float(downscale_loss(sr, lr, 4))
    torch.cuda.synchronize()
    launched = {k: n for k, n in read_launches().items() if n}
    if launched:
        fail(f"the block library launched port kernels: {launched}")
    seconds = time.perf_counter() - t0
    print(f"library on the card against the CPU (rel. to max|ref|, "
          f"{seconds:.1f} s, no kernel launched): " + ", ".join(
              f"{k} {v['rel_err']:.2e}" for k, v in out.items()
              if isinstance(v, dict) and "rel_err" in v)
          + f"; global-attention D penalty {gp_got:.6e} (CPU {gp_ref:.6e}), "
          f"worst D gradient {worst[1]} {worst[0]:.2e} of {len(g_got)} "
          f"[{smi}]")
    return out


def phase_attention_grammar(smi: str) -> dict:
    """The attention grammar's ablations of SRADSGAN and SRAGAN's
    ``ga_mode`` (GRAMMAR_CASES) at full width through the kernels, then the
    block library on the card:

    (a) each case's x4 forward against the CPU and fused against unfused,
    with launches exact and equal to the table; its f32 and mixed WGAN-GP
    steps at batch 16, launches exact, median ms (:func:`_grammar_case`,
    through the zoo's :func:`_zoo_forward` and :func:`_zoo_gan_step`);
    (b) one float32 step of the cases in GRAMMAR_GRAD_CHECKS against the
    CPU's float64 step at the bars of phase 5, each tensor held to the
    fixed bar or twice its kernel-free float32 readings
    (:func:`phase_train_correctness` with ``kernel_free_control``);
    (c) the library's networks at their published sizes
    (:func:`_library_on_card`)."""
    t_start = time.perf_counter()
    batch4 = np.random.default_rng(3).random((4, 54, 54, 3),
                                             dtype=np.float32)
    rows, paths = {}, {}
    for case in GRAMMAR_CASES:
        res = _grammar_case(case, smi, batch4)
        rows[case] = res["row"]
        paths.update(res["paths"])
    grad_checks = {}
    for case, rab in GRAMMAR_GRAD_CHECKS:
        spec = GRAMMAR_CASES[case]
        check = {"model": spec["model"], "model_kwargs": spec["model_kwargs"],
                 "gains": {}, "tol": GRAD_TOL, "kernel_free_control": True,
                 "align_kinks": True}
        res = phase_train_correctness(rab, None, check)
        grad_checks[f"{case}_{rab}"] = res["grad_check"]
        paths[f"grammar_{case}_grad_check_{rab}"] = res["launches"]
        torch.cuda.empty_cache()
    library = _library_on_card(smi)
    seconds = time.perf_counter() - t_start
    print(f"attention grammar phase: {seconds:.1f} s")
    return {"cases": rows, "grad_checks": grad_checks, "library": library,
            "seconds": seconds, "launches_by_path": paths}


def phase_hat(smi: str) -> dict:
    """HAT x4 at its published width and depth, seeded fan-in weights
    (``zoo_init``; its bias tables keep the seeded init): the batch-1
    forward on the card (f32, TF32 off) against the CPU plain path, the
    batch-4 request in f32 and bf16 (no kernel may launch), the L1 step at
    batch 16 in f32 and mixed precision, and ``cli train --model hat``."""
    t_start = time.perf_counter()
    batch = np.random.default_rng(3).random((4, 54, 54, 3),
                                            dtype=np.float32)
    model = create_generator("hat", 4, seed=0)
    zoo_init(model, seed=5)
    model.eval()
    t0 = time.perf_counter()
    ref = forward_numpy(model, batch[:1], "cpu")
    cpu_s = time.perf_counter() - t0
    pred = Predictor(model, 4)
    reset_launches()
    got = pred(batch)
    torch.cuda.synchronize()
    launches = read_launches()
    if any(launches.values()):
        fail(f"HAT launched kernels: {launches}")
    if got.shape != (4, 216, 216, 3) or not np.isfinite(got).all():
        fail(f"HAT output {got.shape}, finite={np.isfinite(got).all()}")
    err = float(np.abs(got[:1] - ref).max())
    bound = SLICE_TOL * float(np.abs(ref).max())
    pred_bf16 = Predictor(model, 4, dtype=torch.bfloat16)
    out_bf16 = pred_bf16(batch)
    if not np.isfinite(out_bf16).all():
        fail("HAT bf16 output is not finite")
    out = {"max_abs_err": err, "bound": bound, "cpu_s": cpu_s,
           "psnr_bf16_vs_f32_db": psnr(out_bf16, got),
           "f32_ms": latency_ms(pred, batch, iters=5),
           "bf16_ms": latency_ms(pred_bf16, batch, iters=5),
           "params_m": sum(p.numel() for p in model.parameters()) / 1e6}
    print(f"HAT x4, batch 4 x 54^2 -> 216^2 ({out['params_m']:.2f} M "
          f"parameters): card f32 vs CPU plain path (1 image) max|d| "
          f"{err:.3e} <= {bound:.3e}; bf16 vs f32 PSNR "
          f"{out['psnr_bf16_vs_f32_db']:.2f} dB; {out['f32_ms']:.2f} ms f32, "
          f"{out['bf16_ms']:.2f} ms bf16 a request; CPU took {cpu_s:.1f} s "
          f"[{smi}]")
    if not err <= bound:
        fail("HAT: the card's output disagrees with the CPU plain path")
    del pred, pred_bf16, model
    torch.cuda.empty_cache()

    step_batch = make_batch()
    mpix = 16 * 216 * 216 / 1e6
    for precision in ("f32", "bf16"):
        trainer = make_trainer(precision, model="hat")
        trainer.train_step(step_batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = 3
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = trainer.train_step(step_batch)
        losses = {k: float(v) for k, v in metrics.items()}  # waits
        ms = (time.perf_counter() - t0) / steps * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[f"{precision}_ms_per_step"] = ms
        out[f"{precision}_mp_per_s"] = mpix / (ms / 1e3)
        out[f"{precision}_peak_gib"] = peak
        print(f"HAT x4 L1 train step batch 16 x 54^2 -> 216^2 {precision}: "
              f"{ms:.2f} ms/step, {mpix / (ms / 1e3):.3f} MP/s of HR "
              f"output, peak {peak:.2f} GiB; losses {losses} [{smi}]")
        if not np.isfinite(list(losses.values())).all():
            fail(f"HAT {precision} step losses are not finite: {losses}")
        del trainer, metrics
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as save_dir:
        _zoo_cli_train("hat", save_dir, smi)
    print("cli train --model hat --steps 2 at small widths returned 0")
    out["seconds"] = time.perf_counter() - t_start
    print(f"HAT phase: {out['seconds']:.1f} s")
    return out


# phase_export: the artifacts are loaded and run by this program in a
# fresh interpreter that imports the port alone; argv: the directory holding
# x.npy, <case>.pt2 and <case>.state.pt, then JSON {case: [model name,
# constructor arguments, the device to load the program onto or null for
# the one it was exported on]}.  It prints one JSON line, by case.
EXPORT_CHILD = """
import json, sys, time
import numpy as np, torch
from sradsgan_tpu_torch.evaluation.tiled import forward_numpy
from sradsgan_tpu_torch.models import create_generator
from sradsgan_tpu_torch.ops import pooling, rab_tail, sgam_flash, spatial_gate
from sradsgan_tpu_torch.serving import load_exported

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
tmp, cases = sys.argv[1], json.loads(sys.argv[2])
wrappers = {"avg_max_pool": pooling.avg_max_pool_cuda,
            "spatial_gate": spatial_gate.spatial_gate_cuda,
            "position_attention": sgam_flash.position_attention_cuda,
            "spatial_gate_bwd": spatial_gate.spatial_gate_bwd_cuda,
            "position_attention_bwd": sgam_flash.position_attention_bwd_cuda,
            "rab_tail": rab_tail.rab_tail_cuda}

def counted(run):
    for f in wrappers.values():
        f.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k: f.launches for k, f in wrappers.items()}

x = np.load(f"{tmp}/x.npy")
rows = {}
for case, (name, kwargs, device) in cases.items():
    t0 = time.perf_counter()
    program = load_exported(f"{tmp}/{case}.pt2", device)
    load_s = time.perf_counter() - t0
    model = create_generator(name, 4, **kwargs)
    model.load_state_dict(torch.load(f"{tmp}/{case}.state.pt",
                                     weights_only=True))
    model = model.cuda().eval()
    runs = {"program": lambda: program(x),
            "eager": lambda: forward_numpy(model, x, "cuda")}
    got, program_launches = counted(runs["program"])
    want, eager_launches = counted(runs["eager"])
    for _ in range(3):
        runs["program"](), runs["eager"]()
    turns = {"program": [], "eager": []}
    for _ in range(5):
        for key, run in runs.items():
            t0 = time.perf_counter()
            for _ in range(10):
                run()
            turns[key].append((time.perf_counter() - t0) / 10 * 1e3)
    rows[case] = {
        "max_abs_err": float(np.abs(got - want).max()),
        "max_ref": float(np.abs(want).max()), "shape": list(got.shape),
        "program_launches": program_launches,
        "eager_launches": eager_launches, "program_ms": turns["program"],
        "eager_ms": turns["eager"], "load_s": load_s}
    del program, model, runs
rows["jax_or_jax_package"] = any(
    m in sys.modules for m in ("jax", "flax", "sradsgan_tpu"))
print(json.dumps(rows))
"""
# case: (model, constructor arguments, the launches of one call, the
# device the program is exported on); one traced on the CPU is loaded onto
# the card.
UNFUSED_CALL = {"avg_max_pool": 48, "spatial_gate": 48,
                "position_attention": 1}
EXPORT_CASES = {
    "sradsgan": ("sradsgan", {}, UNFUSED_CALL, "cuda"),
    "sradsgan_fused": ("sradsgan", {"rab_tail": "fused"},
                       {"rab_tail": 48, "position_attention": 1}, "cuda"),
    "hat": ("hat", {}, {}, "cuda"),
    "sradsgan_from_cpu": ("sradsgan", {}, UNFUSED_CALL, "cpu"),
}


def phase_export(smi: str) -> dict:
    """Each case of EXPORT_CASES at x4, full width, seeded fan-in weights
    (``zoo_init``): exported at batch 1 of 54^2 on the card (or on the CPU
    and loaded onto the card), then loaded and run in a fresh interpreter
    (EXPORT_CHILD), where each loaded program's output must equal the
    eager generator's on the card within 1e-6 of max|ref| and its one call
    must launch exactly the kernels the case lists."""
    t_start = time.perf_counter()
    out = {}
    x = np.random.default_rng(4).random((1, 54, 54, 3), dtype=np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "x.npy"), x)
        for case, (name, kwargs, _, device) in EXPORT_CASES.items():
            model = create_generator(name, 4, seed=0, **kwargs)
            zoo_init(model, seed=5)
            torch.save(model.state_dict(),
                       os.path.join(tmp, f"{case}.state.pt"))
            t0 = time.perf_counter()
            path = export_model(model, 54, os.path.join(tmp, f"{case}.pt2"),
                                device=device)
            out[case] = {"export_s": time.perf_counter() - t0,
                         "artifact_mb": os.path.getsize(path) / 2 ** 20}
            del model
        cases = {case: [name, kwargs, "cuda" if device == "cpu" else None]
                 for case, (name, kwargs, _, device)
                 in EXPORT_CASES.items()}
        child = subprocess.run(
            [sys.executable, "-c", EXPORT_CHILD, tmp, json.dumps(cases)],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    if child.returncode != 0:
        fail(f"loading the artifacts failed:\n{child.stderr[-3000:]}")
    rows = json.loads(child.stdout.strip().splitlines()[-1])
    if rows.pop("jax_or_jax_package"):
        fail("loading the artifacts imported JAX or the JAX package")
    for case, (_, _, launches, device) in EXPORT_CASES.items():
        row = out[case]
        row.update(rows[case])
        want = {k: launches.get(k, 0) for k in KERNELS}
        med = {k: float(np.median(row[f"{k}_ms"]))
               for k in ("program", "eager")}
        print(f"export {case} x4 (1 x 54^2, f32): exported on {device} in "
              f"{row['export_s']:.1f} s, {row['artifact_mb']:.1f} MiB, "
              f"loaded in {row['load_s']:.1f} s in a fresh interpreter; "
              f"loaded vs eager max|d| {row['max_abs_err']:.3e} (max|ref| "
              f"{row['max_ref']:.3f}); launches a call "
              f"{row['program_launches']}; ms a request over alternating "
              f"turns: loaded {[round(v, 3) for v in row['program_ms']]} "
              f"median {med['program']:.3f}, eager "
              f"{[round(v, 3) for v in row['eager_ms']]} median "
              f"{med['eager']:.3f} [{smi}]")
        if not row["max_abs_err"] <= 1e-6 * row["max_ref"]:
            fail(f"the loaded {case} program disagrees with the eager "
                 "generator")
        if row["program_launches"] != want or row["eager_launches"] != want:
            fail(f"{case}: launches a call, loaded {row['program_launches']}"
                 f", eager {row['eager_launches']}, not {want}")
    out["seconds"] = time.perf_counter() - t_start
    print(f"export phase: {out['seconds']:.1f} s")
    return out


# phase_diffusion: the GDP UNet of the shipped config gdp_train_54_216 (inner
# 64, mults (1, 2, 4, 8), 2 res blocks, attention at downsample rate 8)
DIFFUSION_CONFIG = "gdp_train_54_216"
DIFFUSION_STEP_GRAD_TOL = 1e-3  # each tensor, of its own max |ref|
# float32 FMA outside the tensor cores (TF32 is off here): the rate the
# float32 UNet's convs can reach at most
PEAK_FP32_CUDA_CORES = 67e12


def unet_flops(model, x: torch.Tensor, t: torch.Tensor) -> float:
    """The multiply-adds (times two) of one UNet forward on ``x``, counted
    from the shapes its convs, linears and attention products see (hooks on
    a forward); GroupNorm, SiLU and the elementwise terms are left out."""
    from sradsgan_tpu_torch.diffusion.unet import AttnBlock
    total = [0.0]

    def conv_or_linear(m, inputs, out):
        fan_in = m.weight[0].numel()
        total[0] += 2.0 * out.numel() * fan_in

    def attention(m, inputs, out):
        b, c, h, w = inputs[0].shape
        total[0] += 2 * 2.0 * b * (h * w) ** 2 * c  # q k^T and attn v

    hooks = [m.register_forward_hook(
        attention if isinstance(m, AttnBlock) else conv_or_linear)
        for m in model.modules()
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear, AttnBlock))]
    try:
        with torch.no_grad():
            model(x, t)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def _unet_step(model, sched, batch, t, noise):
    """The x0-prediction loss and its parameter gradients, on the model's
    device and dtype."""
    from sradsgan_tpu_torch.diffusion.gaussian import p_losses_given
    p = next(model.parameters())
    x0, cond, noise = (v.to(p.device, p.dtype) for v in
                       (batch["HR"], batch["SR"], noise))
    model.zero_grad(set_to_none=True)
    loss = p_losses_given(model, sched, x0, cond, t.to(p.device), noise)
    loss.backward()
    return float(loss.detach()), {n: q.grad.detach().double().cpu()
                         for n, q in model.named_parameters()}


def phase_diffusion(smi: str) -> dict:
    """GDP conditional diffusion at the shipped width (DIFFUSION_CONFIG;
    seeded fan-in weights, so that no conv is zero): (a) one 216^2 forward,
    card float32 against the CPU plain path, and a bf16 forward; (b) one
    float32 step of the x0 loss at batch 2 of 64^2 against the CPU's in
    float64, given the same t and noise, the CPU's float32 step as the
    control; (c) the trainer's step at batch 4 of 216^2 in float32 and
    mixed precision; (d) ms a denoising step of one 216^2 image in both,
    the whole 1000-step chain in both, and an 8-step chain at 64^2 fed the
    same noise on the card and on the CPU; (e) the three diffusion
    commands at 64^2; (f) no kernel of K1-K6 launched throughout."""
    from sradsgan_tpu_torch.diffusion.config import (
        load_gdp_config, trainer_kwargs_from_config)
    from sradsgan_tpu_torch.diffusion.gaussian import (Schedule,
                                                       p_sample_loop,
                                                       p_sample_step)
    from sradsgan_tpu_torch.diffusion.trainer import DiffusionTrainer
    from sradsgan_tpu_torch.diffusion.unet import UNet

    t_start = time.perf_counter()
    kwargs = trainer_kwargs_from_config(load_gdp_config(DIFFUSION_CONFIG))
    unet_kwargs = kwargs["unet_kwargs"]
    out = {"config": DIFFUSION_CONFIG, "card": smi}
    rng = np.random.default_rng(8)
    reset_launches()

    # (a) the forward at 216^2
    model = UNet(**unet_kwargs, seed=0)
    fan_in_init(model, seed=6)
    model.eval()
    out["params_m"] = sum(p.numel() for p in model.parameters()) / 1e6
    x = torch.from_numpy(rng.normal(0, 1, (1, 6, 216, 216)).astype(
        np.float32))
    t = torch.tensor([500])
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = model(x, t)
    out["cpu_forward_s"] = time.perf_counter() - t0
    card = copy.deepcopy(model).cuda()
    with torch.no_grad():
        got = card(x.cuda(), t.cuda())
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got_bf16 = card(x.cuda(), t.cuda())
    flops = unet_flops(card, x.cuda(), t.cuda())
    out["gflop_forward_216"] = flops / 1e9
    scale = float(ref.abs().max())
    err = float((got.cpu() - ref).abs().max())
    bf16_err = float((got_bf16.float().cpu() - ref).abs().max()) / scale
    if not torch.isfinite(got_bf16).all():
        fail("diffusion: the bf16 forward is not finite")
    out["forward"] = {"max_abs_err": err, "bound": SLICE_TOL * scale,
                      "max_ref": scale, "bf16_rel_err_vs_f32": bf16_err}
    print(f"diffusion UNet {DIFFUSION_CONFIG} ({out['params_m']:.2f} M "
          f"parameters, {flops / 1e9:.1f} GFLOP a 216^2 forward by the "
          f"hooks' count): card f32 vs CPU plain path max|d| {err:.3e} <= "
          f"{SLICE_TOL * scale:.3e}; bf16 vs f32 {bf16_err:.3e} of max|ref| "
          f"[{smi}]")
    if not err <= SLICE_TOL * scale:
        fail("diffusion: the card's 216^2 forward disagrees with the CPU")
    del card, got, got_bf16, ref
    torch.cuda.empty_cache()

    # (b) one float32 step against float64, batch 2 of 64^2
    sched = Schedule.create(kwargs["schedule"], kwargs["n_timestep"],
                            kwargs["linear_start"], kwargs["linear_end"])
    batch = {k: torch.from_numpy(rng.uniform(-1, 1, (2, 3, 64, 64)).astype(
        np.float32)) for k in ("HR", "SR")}
    t = torch.tensor([37, 811])
    noise = torch.from_numpy(rng.normal(0, 1, (2, 3, 64, 64)).astype(
        np.float32))
    model.train()
    ref_loss, ref_grads = _unet_step(copy.deepcopy(model).double(), sched,
                                     batch, t, noise)
    readings = {}
    for where, net in (("card", copy.deepcopy(model).cuda()),
                       ("cpu", model)):
        loss, grads = _unet_step(net, sched, batch, t, noise)
        errs = {n: float((g - ref_grads[n]).abs().max()
                         / ref_grads[n].abs().max()) for n, g in grads.items()}
        worst = max(errs, key=errs.get)
        readings[where] = {"loss": loss, "loss_err": abs(loss - ref_loss),
                           "worst_grad": worst,
                           "worst_grad_err": errs[worst]}
        del net
    out["step_check"] = {"ref_loss": ref_loss, **readings,
                         "grad_tol": DIFFUSION_STEP_GRAD_TOL}
    print(f"diffusion f32 step (batch 2 x 64^2) vs float64: loss "
          f"{ref_loss:.6f}; card loss err {readings['card']['loss_err']:.3e},"
          f" worst grad {readings['card']['worst_grad_err']:.3e} "
          f"({readings['card']['worst_grad']}); CPU f32 control loss err "
          f"{readings['cpu']['loss_err']:.3e}, worst grad "
          f"{readings['cpu']['worst_grad_err']:.3e} "
          f"({readings['cpu']['worst_grad']}) [{smi}]")
    for where, r in readings.items():
        if not (r["loss_err"] <= LOSS_TOL * max(abs(ref_loss), 0.01)
                and r["worst_grad_err"] <= DIFFUSION_STEP_GRAD_TOL):
            fail(f"diffusion: the {where} float32 step misses its bars: {r}")
    torch.cuda.empty_cache()

    # (c) the trainer's step at batch 4 of 216^2
    data_cfg = DataConfig(synthetic=True, crop_size=216, test_crop_size=216,
                          batch_size=4)
    step_batch = {k: torch.from_numpy(rng.uniform(-1, 1, (4, 3, 216, 216))
                                      .astype(np.float32)).cuda()
                  for k in ("HR", "SR")}  # on the card, as the feed hands it
    mpix = 4 * 216 * 216 / 1e6
    step_flops = 3 * 4 * flops
    peaks = {"f32": PEAK_FP32_CUDA_CORES,
             "bf16": PEAK_FLOPS[torch.bfloat16]}
    out["train_step"] = {"gflop": step_flops / 1e9}
    with tempfile.TemporaryDirectory() as save_dir:
        for precision in ("f32", "bf16"):
            trainer = DiffusionTrainer(
                data_cfg, kwargs["scale"], save_dir=save_dir,
                unet_kwargs=unet_kwargs, bf16=precision == "bf16",
                device="cuda")
            fan_in_init(trainer.unet, seed=6)
            gen = torch.Generator("cuda").manual_seed(1)
            trainer.train_step(step_batch, gen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            steps = 3
            t0 = time.perf_counter()
            for _ in range(steps):
                loss = trainer.train_step(step_batch, gen)
            loss = float(loss)  # waits
            ms = (time.perf_counter() - t0) / steps * 1e3
            row = {"ms_per_step": ms, "mp_per_s": mpix / (ms / 1e3),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "tflop_per_s": step_flops / (ms / 1e3) / 1e12,
                   "loss": loss}
            row["share_of_peak"] = row["tflop_per_s"] * 1e12 / peaks[
                precision]
            # float32 also against the TF32 tensor-core peak (495 TFLOP/s)
            tf32 = (f", {100 * row['tflop_per_s'] / 495:.2f} % of TF32's 495"
                    if precision == "f32" else "")
            out["train_step"][precision] = row
            print(f"diffusion train step batch 4 x 216^2 {precision}: "
                  f"{ms:.2f} ms/step, {row['mp_per_s']:.3f} MP/s of HR, "
                  f"peak {row['peak_gib']:.2f} GiB, {row['tflop_per_s']:.1f}"
                  f" TFLOP/s = {100 * row['share_of_peak']:.1f} % of "
                  f"{peaks[precision] / 1e12:.0f} TFLOP/s{tf32}; loss "
                  f"{loss:.5f} [{smi}]")
            if not np.isfinite(loss):
                fail(f"diffusion {precision} step loss is not finite")
            del trainer
            torch.cuda.empty_cache()

    # (d) sampling: one 216^2 image
    card = copy.deepcopy(model).cuda().eval()
    cond = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 216, 216)).astype(
        np.float32)).cuda()
    img = torch.randn(cond.shape, device="cuda")
    step_noise = torch.randn(cond.shape, device="cuda")
    out["sampling"] = {}
    for precision in ("f32", "bf16"):
        def denoise(xx, tt, bf16=precision == "bf16"):
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
                return card(xx, tt)
        with torch.no_grad():
            for _ in range(2):
                p_sample_step(denoise, sched, img, cond, 500, step_noise)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for step in range(20):
                p_sample_step(denoise, sched, img, cond, 999 - step,
                              step_noise)
            torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 20 * 1e3
        gen = torch.Generator("cuda").manual_seed(0)
        t0 = time.perf_counter()
        sample = p_sample_loop(denoise, sched, cond, gen)
        sample_np = sample.cpu().numpy()  # waits
        chain_s = time.perf_counter() - t0
        if not np.isfinite(sample_np).all() or sample_np.shape != (
                1, 3, 216, 216):
            fail(f"diffusion {precision} sample {sample_np.shape} is not "
                 "finite")
        out["sampling"][precision] = {
            "ms_per_step": step_ms, "chain_s": chain_s,
            "steps": sched.num_timesteps,
            "tflop_per_s": flops / (step_ms / 1e3) / 1e12}
        print(f"diffusion sampling 1 x 216^2 {precision}: {step_ms:.2f} ms "
              f"a denoising step ({flops / (step_ms / 1e3) / 1e12:.1f} "
              f"TFLOP/s), the whole {sched.num_timesteps}-step chain "
              f"{chain_s:.2f} s [{smi}]")
    del card
    torch.cuda.empty_cache()
    short = Schedule.create(kwargs["schedule"], 8, kwargs["linear_start"],
                            kwargs["linear_end"])
    cond64 = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 64, 64)).astype(
        np.float32))
    model.eval()
    ref = p_sample_loop(model, short, cond64,
                        torch.Generator().manual_seed(3))
    got = p_sample_loop(copy.deepcopy(model).cuda(), short, cond64.cuda(),
                        torch.Generator().manual_seed(3))
    scale = float(ref.abs().max())
    err = float((got.cpu() - ref).abs().max())
    out["chain_check"] = {"steps": 8, "max_abs_err": err,
                          "bound": SLICE_TOL * scale}
    print(f"diffusion 8-step chain 1 x 64^2, the same noise: card vs CPU "
          f"max|d| {err:.3e} <= {SLICE_TOL * scale:.3e} [{smi}]")
    if not err <= SLICE_TOL * scale:
        fail("diffusion: the card's 8-step chain disagrees with the CPU's")
    launches = read_launches()

    # (e) the three commands at 64^2
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--device", "cuda", "--data", "synthetic", "--scale", "4",
                  "--crop-size", "64", "--save-dir", tmp]
        lines, ran = _cli_run(["diffusion-train", "--gdp-config",
                               DIFFUSION_CONFIG, "--n-iter", "3",
                               "--batch-size", "4"] + common, smi)
        launches = {k: v + ran[k] for k, v in launches.items()}
        trained = json.loads(lines[-1])
        if not (np.isfinite(trained["final_loss"])
                and os.path.exists(trained["ckpt"])):
            fail(f"diffusion-train: {trained}")
        out["cli"] = {"train_loss": trained["final_loss"]}
        for mode in ("plain", "continuous"):
            result_dir = os.path.join(tmp, f"val_{mode}")
            argv = ["diffusion-validate", "--ckpt", trained["ckpt"],
                    "--timesteps", "10", "--max-images", "1",
                    "--result-dir", result_dir] + common
            lines, ran = _cli_run(
                argv + (["--continuous"] if mode == "continuous" else []),
                smi)
            launches = {k: v + ran[k] for k, v in launches.items()}
            val = json.loads(lines[-1])
            val.pop("result_dir")
            if len(val) != 10 or not np.isfinite(list(val.values())).all():
                fail(f"diffusion-validate {mode}: {val}")
            out["cli"][f"validate_{mode}"] = val
        lr = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
        np.save(os.path.join(tmp, "lr.npy"), lr)
        lines, ran = _cli_run(["diffusion-sample", "--ckpt", trained["ckpt"],
                               "--timesteps", "10", "--image",
                               os.path.join(tmp, "lr.npy"), "--out-dir",
                               os.path.join(tmp, "sample")] + common, smi)
        launches = {k: v + ran[k] for k, v in launches.items()}
        path = json.loads(lines[-1])["sr"]
        if path.endswith(".npy"):
            sr = np.load(path)
            if sr.shape != (64, 64, 3) or not np.isfinite(sr).all():
                fail(f"diffusion-sample wrote {sr.shape}")
        elif not os.path.exists(path):
            fail(f"diffusion-sample wrote nothing at {path}")
        out["cli"]["sample"] = os.path.basename(path)
    print(f"cli diffusion-train (3 steps, {DIFFUSION_CONFIG} at 64^2), "
          f"diffusion-validate (10 steps, plain and continuous), "
          f"diffusion-sample (10 steps, 16^2 -> 64^2) returned 0: "
          f"{out['cli']}")

    # (f) no kernel on this path
    out["launches"] = launches
    if any(launches.values()):
        fail(f"the diffusion path launched kernels: {launches}")
    out["seconds"] = time.perf_counter() - t_start
    print(f"diffusion phase: {out['seconds']:.1f} s, kernel launches "
          f"{launches}")
    return out


# phase_data_parallel: the data mesh (parallel/mesh.py) on the card
DP_SEED, DP_ALPHA_SEED, DP_DRAW_SEED = 21, 7, 1
DP_STEPS = 3            # steps of each rank, after which they must be equal
DP_TURNS = ("plain", "group", "group", "plain") * 2  # alternating timing
DP_TIMED_STEPS = 3      # steps a turn
# The D's running statistics after the first step, two ranks against one
# process: global statistics summed in another order (values of order one)
STAT_TOL = 1e-5
DP_DEADLINE_S = 600.0


def _grads_of(model: torch.nn.Module) -> dict:
    return {n: p.grad.detach().cpu().clone()
            for n, p in model.named_parameters()}


def _dp_grad_faults(got: dict, ref: dict, zero: set, tol: float,
                    what: str) -> tuple:
    """(worst error of max|ref| outside ``zero``, its name, faults): every
    gradient within ``tol`` of its own max|ref|, one that is zero by the
    math (``zero``) within ZERO_TOL of the network's largest."""
    largest = max(float(g.abs().max()) for g in ref.values())
    worst, worst_name, faults = 0.0, "", []
    if set(got) != set(ref):
        return 0.0, "", [f"{what}: gradient names differ"]
    for name, g in ref.items():
        err = float((got[name].double() - g.double()).abs().max())
        if name in zero:
            if not err <= ZERO_TOL * largest:
                faults.append(f"{what} {name} (zero by the math) off by "
                              f"{err:.3e}, over {ZERO_TOL:.0e} of the "
                              f"network's largest {largest:.3e}")
            continue
        scale = float(g.abs().max())
        rel = err / scale if scale else (0.0 if err == 0 else float("inf"))
        if rel > worst:
            worst, worst_name = rel, name
        if not rel <= tol:
            faults.append(f"{what} {name} off by {rel:.3e} of max|ref|, over "
                          f"{tol:.0e}")
    return worst, worst_name, faults


def _dp_nccl_world_one(smi: str, batch: dict, store: str) -> dict:
    """(a): the flagship's step with a process group of one NCCL rank
    against the same step without a group, then both timed over
    alternating turns.  Returns the report, the group step's launches and
    the reference: its initial weights, losses, gradients and D running
    statistics."""
    import dataclasses

    from sradsgan_tpu_torch.parallel.mesh import create_mesh

    plain = _fan_in_trainer("cuda")
    initial = {"generator": plain.generator, "vgg": plain.vgg,
               "discriminator": plain.discriminator}
    initial = {k: {n: t.detach().cpu().clone()
                   for n, t in m.state_dict().items()}
               for k, m in initial.items()}
    grouped = _fan_in_trainer("cuda")
    mesh = create_mesh(1, "cuda", rank=0, world=1,
                       init_method=f"file://{store}")
    backend = torch.distributed.get_backend(mesh.group)
    grouped.mesh = mesh
    grouped.graphed = False  # a trainer in a group steps eagerly
    no_group = dataclasses.replace(mesh, group=None)
    try:
        reset_launches()
        got = grouped.train_step(batch,
                                 torch.Generator().manual_seed(DP_ALPHA_SEED))
        torch.cuda.synchronize()
        launches = read_launches()
        want = plain.train_step(batch,
                                torch.Generator().manual_seed(DP_ALPHA_SEED))
        faults = []
        if launches != step_launches(grouped):
            faults.append(f"the NCCL step launched {launches}, not the "
                          f"single-process step's {step_launches(grouped)}")
        losses = {k: float(v) for k, v in want.items()}
        for key, value in losses.items():
            if not abs(float(got[key]) - value) <= LOSS_TOL * max(
                    abs(value), 1e-2):
                faults.append(f"NCCL step {key} {float(got[key])!r} vs "
                              f"{value!r} without a group")
        report = {"backend": backend, "card": smi}
        ref_grads = {}
        equal = True
        for net in ("generator", "discriminator"):
            ref_grads[net] = _grads_of(getattr(plain, net))
            mine = _grads_of(getattr(grouped, net))
            equal &= all(torch.equal(mine[n], g)
                         for n, g in ref_grads[net].items())
            worst, name, bad = _dp_grad_faults(
                mine, ref_grads[net], zero_by_math(getattr(plain, net)),
                GRAD_TOL[net], f"NCCL {net}")
            faults += bad
            report[f"{net}_worst"] = {"name": name, "err": worst,
                                      "tol": GRAD_TOL[net]}
        report["bit_equal_to_no_group"] = bool(equal)
        ref_stats = {k: v.detach().cpu().clone() for k, v in
                     plain.discriminator.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
        print(f"data parallel (a) NCCL world 1 ({backend}), flagship x4 "
              f"batch 16 f32: launches {launches}; losses and gradients "
              f"against the step without a group: bit-equal "
              f"{report['bit_equal_to_no_group']}, worst G "
              f"{report['generator_worst']['err']:.3e} "
              f"({report['generator_worst']['name']}), worst D "
              f"{report['discriminator_worst']['err']:.3e} "
              f"({report['discriminator_worst']['name']}) [{smi}]")
        if faults:
            fail("data parallel (a): " + "; ".join(faults))
        # the all-reduces' cost at world 1: the same trainer with and
        # without its group, in alternating turns
        times = {"plain": [], "group": []}
        gen = torch.Generator().manual_seed(DP_ALPHA_SEED)
        # both turns eager (``graphed`` off above), so the turns compare
        # the all-reduces alone
        for turn in DP_TURNS:
            grouped.mesh = mesh if turn == "group" else no_group
            grouped.train_step(batch, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DP_TIMED_STEPS):
                metrics = grouped.train_step(batch, gen)
            float(metrics["loss_G"])  # waits
            times[turn].append((time.perf_counter() - t0) / DP_TIMED_STEPS
                               * 1e3)
        report["ms_per_step"] = times
        med = {k: float(np.median(v)) for k, v in times.items()}
        report["median_ms"] = med
        report["all_reduce_cost_ms"] = med["group"] - med["plain"]
        print(f"data parallel (a) step time over alternating turns "
              f"{DP_TURNS}: with the group {times['group']} ms, without "
              f"{times['plain']} ms; medians {med['group']:.2f} / "
              f"{med['plain']:.2f} ms, the world-1 all-reduces' cost "
              f"{report['all_reduce_cost_ms']:+.2f} ms a step [{smi}]")
    finally:
        torch.distributed.destroy_process_group()
    reference = {"weights": initial, "losses": losses, "grads": ref_grads,
                 "stats": ref_stats, "launches": step_launches(plain),
                 "cfg": plain.cfg,
                 "zero": {net: zero_by_math(getattr(plain, net))
                          for net in ("generator", "discriminator")}}
    return report, launches, reference


def _dp_diffusion_reference(batch: dict, weights_path: str) -> dict:
    """(c)'s one-process card step: the full-width UNet with seeded fan-in
    weights (saved to ``weights_path``) at batch 4 of 216^2."""
    from sradsgan_tpu_torch.diffusion.config import (
        load_gdp_config, trainer_kwargs_from_config)
    from sradsgan_tpu_torch.diffusion.trainer import DiffusionTrainer

    unet_kwargs = trainer_kwargs_from_config(
        load_gdp_config(DIFFUSION_CONFIG))["unet_kwargs"]
    with tempfile.TemporaryDirectory() as save_dir:
        trainer = DiffusionTrainer(DataConfig(crop_size=216, batch_size=4), 4,
                                   save_dir=save_dir, unet_kwargs=unet_kwargs,
                                   bf16=False, device="cuda")
    fan_in_init(trainer.unet, seed=6)
    torch.save({k: v.cpu() for k, v in trainer.unet.state_dict().items()},
               weights_path)
    loss = float(trainer.train_step(
        batch, torch.Generator("cuda").manual_seed(DP_DRAW_SEED)))
    return {"loss": loss, "grads": _grads_of(trainer.unet),
            "unet_kwargs": unet_kwargs}


def _dp_hold(ranks: list, ref: dict, diff_ref: dict, label: str) -> tuple:
    """(report, faults) of ranks' results (``tools/dp_check.py``) against
    the one-process card steps: each rank's launches, losses (LOSS_TOL),
    G and D gradients (GRAD_TOL, ZERO_TOL), the D's running statistics
    (STAT_TOL), the UNet's loss and gradients (DIFFUSION_STEP_GRAD_TOL),
    and the ranks' parameters bit-equal after DP_STEPS steps.  A scenario
    a run left out (its global batch not split by the ranks) is skipped."""
    faults = []
    report = {"ranks": len(ranks)}
    for rank, res in enumerate(ranks):
        gan, diff = res.get("gan"), res.get("diffusion")
        if gan is not None:
            if gan["launches"][0] != ref["launches"]:
                faults.append(f"rank {rank} launched {gan['launches'][0]}, "
                              f"not the single-process step's "
                              f"{ref['launches']}")
            for key, value in ref["losses"].items():
                got = gan["losses"][0][key]
                if not abs(got - value) <= LOSS_TOL * max(abs(value), 1e-2):
                    faults.append(f"rank {rank} {key} {got!r} vs one "
                                  f"process {value!r}")
            for net, zero in ref["zero"].items():
                worst, name, bad = _dp_grad_faults(
                    gan["grads"][net], ref["grads"][net], zero,
                    GRAD_TOL[net], f"rank {rank} {net}")
                faults += bad
                report[f"rank{rank}_{net}_worst"] = {"name": name,
                                                     "err": worst}
            stats = gan["stats"]["discriminator"]
            stat_err = max(float((stats[k] - v).abs().max())
                           for k, v in ref["stats"].items())
            report[f"rank{rank}_d_stats_err"] = stat_err
            if set(stats) != set(ref["stats"]) or not stat_err <= STAT_TOL:
                faults.append(f"rank {rank} D running statistics off by "
                              f"{stat_err:.3e}, over {STAT_TOL:.0e}")
        if diff is not None:
            want = diff_ref["loss"]
            if not abs(diff["losses"][0] - want) <= LOSS_TOL * max(
                    abs(want), 1e-2):
                faults.append(f"rank {rank} diffusion loss "
                              f"{diff['losses'][0]!r} vs one process "
                              f"{want!r}")
            errs = {n: _max_rel(diff["grads"][n], g) if g.abs().max() > 0
                    else (float("inf") if diff["grads"][n].any() else 0.0)
                    for n, g in diff_ref["grads"].items()}
            worst = max(errs, key=errs.get)
            report[f"rank{rank}_unet_worst"] = {"name": worst,
                                                "err": errs[worst]}
            if not errs[worst] <= DIFFUSION_STEP_GRAD_TOL:
                faults.append(f"rank {rank} UNet gradient {worst} off by "
                              f"{errs[worst]:.3e} of max|ref|")
    for scenario in ("gan", "diffusion"):
        if scenario not in ranks[0]:
            continue
        states = [r[scenario]["state"] for r in ranks]
        if scenario == "gan":
            states = [{f"{net}.{k}": v for net, sd in s.items()
                       for k, v in sd.items()} for s in states]
        equal = all(set(s) == set(states[0]) and all(
            torch.equal(s[k], states[0][k]) for k in s) for s in states[1:])
        report[f"{scenario}_bit_equal_after_{DP_STEPS}_steps"] = equal
        if not equal:
            faults.append(f"the ranks' {scenario} parameters differ after "
                          f"{DP_STEPS} steps")
        # host clock a step (its loss read): the median over the turns of
        # the slowest rank's turn, where the run timed turns
        turns = [r[scenario]["turn_ms"] for r in ranks]
        if turns[0]:
            slowest = [max(t) for t in zip(*turns)]
            report[f"{scenario}_turn_ms"] = slowest
            report[f"{scenario}_step_ms"] = float(np.median(slowest))
    head = ", ".join(
        f"{k} {v['err']:.3e}" if isinstance(v, dict) else f"{k} {v}"
        for k, v in report.items() if k.startswith("rank0_")
        or "bit_equal" in k or k.endswith(("turn_ms", "step_ms")))
    print(f"data parallel {label}: {head}")
    return report, [f"{label}: {f}" for f in faults]


def phase_data_parallel(smi: str) -> tuple:
    """The data mesh of ``parallel/mesh.py`` on the card, the flagship at
    full width (x4, 12 groups, seeded fan-in weights, float32):

    (a) a process group of one NCCL rank: the step at batch 16 must launch
    what the single-process step launches and agree with the step without
    a group (GRAD_TOL, LOSS_TOL), and the two are timed over alternating
    turns: the all-reduces' cost at world 1;
    (b) two gloo ranks spawned on this card (``tools/dp_check.py``) at a
    global batch of 16, 8 a rank, the same global penalty weights: each
    rank's launches equal the single-process step's, its losses (LOSS_TOL),
    every G and D gradient (GRAD_TOL, ZERO_TOL) and the D's running
    statistics (STAT_TOL) those of the one-process step at batch 16, and
    after DP_STEPS steps the ranks' parameters are bit-equal;
    (c) the same for ``DiffusionTrainer``'s step at a global batch of 4 x
    216^2 (the UNet of DIFFUSION_CONFIG), the same global t and noise,
    gradients within DIFFUSION_STEP_GRAD_TOL;
    (d) on a machine with more than one card, (b) and (c) again with one
    NCCL rank a card (a scenario whose global batch the cards do not split
    is left out), then each step timed over as many turns and steps as
    (a)'s, against (a)'s step without a group.  The bars are those of a
    float32 step against float64: ranks sum in another order than one
    process.  Returns the
    report and the launches of (a)'s step and of rank 0's first step in
    (b)."""
    from sradsgan_tpu_torch.config import save_config
    from sradsgan_tpu_torch.tools import dp_check

    t_start = time.perf_counter()
    out = {"card": smi}
    batch = dp_check.gan_batches(DP_SEED, 1, 16, 54, 4)[0]
    diff_batch = dp_check.diffusion_batches(DP_SEED, 1, 4, 216)[0]
    with tempfile.TemporaryDirectory() as work:
        out["nccl1"], launches_nccl1, ref = _dp_nccl_world_one(
            smi, batch, os.path.join(work, "store_a"))
        torch.save(ref["weights"], os.path.join(work, "flagship.pt"))
        cfg = ref["cfg"]
        cfg.data.batch_size, cfg.save_dir = 16, work
        save_config(cfg, os.path.join(work, "flagship.json"))
        diff_ref = _dp_diffusion_reference(diff_batch,
                                           os.path.join(work, "unet.pt"))
        torch.cuda.empty_cache()
        scenarios = {
            "gan": {"name": "gan", "kind": "gan",
                    "config": os.path.join(work, "flagship.json"),
                    "weights": os.path.join(work, "flagship.pt"),
                    "seed": DP_SEED, "steps": DP_STEPS, "batch": 16,
                    "lr_size": 54, "alpha_seed": DP_ALPHA_SEED},
            "diffusion": {"name": "diffusion", "kind": "diffusion",
                          "scale": 4, "crop": 216, "batch": 4,
                          "unet_kwargs": diff_ref["unet_kwargs"],
                          "weights": os.path.join(work, "unet.pt"),
                          "seed": DP_SEED, "steps": DP_STEPS,
                          "draw_seed": DP_DRAW_SEED},
            # phase_tiled_and_weights (b) and (d) hold it
            "tiled": tiled_scenario(work)}
        faults = []
        t0 = time.perf_counter()
        ranks = dp_check.run_ranks(
            {"device": "cuda:0", "backend": "gloo", "threads": 4,
             "scenarios": list(scenarios.values())}, 2,
            os.path.join(work, "gloo2"), DP_DEADLINE_S)
        report, bad = _dp_hold(ranks, ref, diff_ref,
                               f"(b, c) two gloo ranks on cuda:0 [{smi}]")
        faults += bad
        report.update(backend="gloo", seconds=time.perf_counter() - t0,
                      gloo_took_cuda_tensors=True)  # the all-reduces ran
        out["gloo2"] = report
        launches_gloo2 = ranks[0]["gan"]["launches"][0]
        tiled_runs = {"gloo2": [r["tiled"] for r in ranks]}
        cards = torch.cuda.device_count()
        if cards > 1:
            split = [sc if sc["kind"] == "tiled" else
                     dict(sc, turns=len(DP_TURNS),
                          timed_steps=DP_TIMED_STEPS)
                     for sc in scenarios.values()
                     if sc.get("batch", cards) % cards == 0]
            t0 = time.perf_counter()
            ranks = dp_check.run_ranks(
                {"device": "cuda", "backend": "nccl", "threads": 4,
                 "scenarios": split}, cards,
                os.path.join(work, f"nccl{cards}"), DP_DEADLINE_S)
            report, bad = _dp_hold(ranks, ref, diff_ref,
                                   f"(d) {cards} NCCL ranks, one a card "
                                   f"[{smi}]")
            faults += bad
            report.update(backend="nccl", seconds=time.perf_counter() - t0,
                          scenarios=[sc["name"] for sc in split])
            tiled_runs[f"nccl{cards}"] = [r["tiled"] for r in ranks]
            if "gan_step_ms" in report:
                one = out["nccl1"]["median_ms"]["plain"]
                speedup = one / report["gan_step_ms"]
                report["gan_speedup_over_one_card"] = speedup
                report["gan_scaling_efficiency"] = speedup / cards
                print(f"data parallel (d): the flagship's step at global "
                      f"batch 16, median of {len(DP_TURNS)} turns of "
                      f"{DP_TIMED_STEPS} steps: {report['gan_step_ms']:.2f} "
                      f"ms on {cards} cards, {one:.2f} ms on one: "
                      f"{speedup:.3f}x [{smi}]")
            out[f"nccl{cards}"] = report
        if faults:
            fail("data parallel: " + "; ".join(faults))
    out["seconds"] = time.perf_counter() - t_start
    print(f"data parallel phase: {out['seconds']:.1f} s")
    return out, launches_nccl1, launches_gloo2, tiled_runs


# phase_tiled_and_weights: an LR scene of 270 x 250 cut into 25 halo tiles
# of 54 + 2 * 8 pixels, in chunks of 16: two chunks, the second a tail of 9
# (padded to 10 on two ranks, to 12 on four)
TILED = {"model": "sradsgan", "scale": 4, "seed": 31, "height": 270,
         "width": 250, "tile": 54, "halo": 8, "batch_tiles": 16}
TILED_TURNS = ["one", "mesh", "mesh", "one"] * 3  # alternating timing
TILED_WEIGHT_SEED = 9


def tiled_flagship() -> torch.nn.Module:
    """The full-width x4 flagship on the CPU in eval mode: seeded fan-in
    weights, both attention gains 0.5."""
    model = create_generator("sradsgan", TILED["scale"], seed=0)
    fan_in_init(model, seed=TILED_WEIGHT_SEED)
    with torch.no_grad():
        model.GAB_UP.ca.gamma.fill_(0.5)
        model.GAB_UP.sa.gamma.fill_(0.5)
    return model.eval()


def tiled_scenario(work: str) -> dict:
    """The ranks' ``tiled`` scenario (``tools/dp_check.py``) of
    :func:`tiled_flagship`, its weights written to ``work``."""
    path = os.path.join(work, "tiled_flagship.pt")
    torch.save(tiled_flagship().state_dict(), path)
    return dict(TILED, name="tiled", kind="tiled", weights=path,
                turns=TILED_TURNS)


def _tiled_chunks(world: int) -> int:
    """How many chunks a world of ``world`` ranks forwards the scene in:
    each chunk the largest multiple of ``world`` up to batch_tiles."""
    tiles = (-(-TILED["height"] // TILED["tile"])
             * -(-TILED["width"] // TILED["tile"]))
    chunk = max(TILED["batch_tiles"] - TILED["batch_tiles"] % world, world)
    return -(-tiles // chunk)


def _hold_tiled_ranks(ranks: list, want: np.ndarray, model, label: str,
                      smi: str) -> tuple:
    """(report, faults) of the ranks' ``tiled`` results against (a)'s
    scene: every rank's scene bit-equal to rank 0's, rank 0's bit-equal to
    (a)'s or within TOL[float32] of its max|ref|, each rank's launches
    those of its chunks' forwards; rank 0's turns timed."""
    world = len(ranks)
    expected = forward_launches(model, forwards=_tiled_chunks(world))
    faults = []
    scenes = [r["scene"].numpy() for r in ranks]
    ranks_equal = all(np.array_equal(sc, scenes[0]) for sc in scenes[1:])
    if not ranks_equal:
        faults.append("the ranks' scenes differ")
    bit_equal = bool(np.array_equal(scenes[0], want))
    rel = float(np.abs(scenes[0] - want).max() / np.abs(want).max())
    if not (bit_equal or rel <= TOL[torch.float32]):
        faults.append(f"rank 0's scene off (a)'s by {rel:.3e} of max|ref|, "
                      f"over {TOL[torch.float32]:.0e}")
    for rank, r in enumerate(ranks):
        if r["launches"] != expected:
            faults.append(f"rank {rank} launched {r['launches']}, not "
                          f"{expected}")
    turns = ranks[0]["turn_ms"]
    med = {k: float(np.median(v)) for k, v in turns.items()}
    report = {"ranks": world, "bit_equal_to_one_process": bit_equal,
              "max_rel_err": rel, "launches_rank0": ranks[0]["launches"],
              "turn_ms": turns, "median_ms": med,
              "speedup": med["one"] / med["mesh"]}
    print(f"tiled {label}: the ranks' scenes bit-equal {ranks_equal}; "
          f"against (a) "
          f"bit-equal {bit_equal}, max|d| {rel:.3e} of max|ref| (bar "
          f"{TOL[torch.float32]:.0e}); rank 0 launched "
          f"{ranks[0]['launches']}; rank 0 alone vs {world} ranks over "
          f"alternating turns {TILED_TURNS}: {turns['one']} / "
          f"{turns['mesh']} ms, medians {med['one']:.1f} / "
          f"{med['mesh']:.1f} ms, {report['speedup']:.3f}x [{smi}]")
    return report, [f"tiled {label}: {f}" for f in faults]


def _torchvision_vgg19(seed: int) -> torch.nn.Module:
    """torchvision's ``vgg19().features[:12]`` layout (``features.{i}``),
    seeded weights."""
    torch.manual_seed(seed)
    m = torch.nn.Module()
    c = torch.nn.Conv2d
    m.features = torch.nn.Sequential(
        c(3, 64, 3, padding=1), torch.nn.ReLU(), c(64, 64, 3, padding=1),
        torch.nn.ReLU(), torch.nn.MaxPool2d(2, 2), c(64, 128, 3, padding=1),
        torch.nn.ReLU(), c(128, 128, 3, padding=1), torch.nn.ReLU(),
        torch.nn.MaxPool2d(2, 2), c(128, 256, 3, padding=1), torch.nn.ReLU())
    return m.eval()


def _weights_check(smi: str) -> dict:
    """(d): a seeded full-width flagship and HAT written as the reference's
    ``.pkl`` state dicts (HAT with the reference's two index buffers),
    read back by ``tools/from_reference.py``: each forward on the card
    bit-equal to the seeded module's; a torchvision-layout VGG19 ``.pth``
    through ``load_vgg19`` (``convert_torch.torchvision_state_dict``): its
    features bit-equal to the module's, its weights those of the ``.npz``
    that ``convert_torch`` writes."""
    import warnings

    from sradsgan_tpu_torch.losses.vgg import load_vgg19
    from sradsgan_tpu_torch.models.hat import rpi_oca, rpi_sa
    from sradsgan_tpu_torch.tools import convert_torch, from_reference

    x = np.random.default_rng(4).random((2, 54, 54, 3), dtype=np.float32)
    hat = create_generator("hat", 4, seed=0)
    zoo_init(hat, seed=5)
    hat_state = dict(hat.state_dict(), relative_position_index_SA=(
        torch.from_numpy(rpi_sa(hat.window))), relative_position_index_OCA=(
        torch.from_numpy(rpi_oca(hat.window, 0.5))))
    out, faults = {}, []
    with tempfile.TemporaryDirectory() as work:
        for name, module, state in (
                ("sradsgan", tiled_flagship(), None), ("hat", hat, hat_state)):
            path = os.path.join(work, f"{name}_generator_param.pkl")
            torch.save(state or module.state_dict(), path)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                loaded = from_reference.load_reference(name, path, 4,
                                                       device="cuda")
            want = forward_numpy(module.cuda().eval(), x, "cuda")
            got = forward_numpy(loaded, x, "cuda")
            equal = bool(np.array_equal(got, want))
            out[name] = {"bit_equal": equal,
                         "max_abs_err": float(np.abs(got - want).max()),
                         "warnings": [str(w.message) for w in caught]}
            if not equal:
                faults.append(f"{name} read from the reference layout is "
                              f"off by {out[name]['max_abs_err']:.3e}")
        tv = _torchvision_vgg19(seed=7)
        pth = os.path.join(work, "vgg19.pth")
        torch.save(tv.state_dict(), pth)
        vgg = load_vgg19(pth, device="cuda")
        npz = os.path.join(work, "vgg19.npz")
        with contextlib.redirect_stdout(io.StringIO()):
            convert_torch.main(["vgg19", pth, npz])
        via_npz = load_vgg19(npz, device="cuda").state_dict()
        xv = torch.from_numpy(np.random.default_rng(5).random(
            (2, 3, 216, 216), dtype=np.float32)).cuda()
        with torch.no_grad():
            equal = bool(torch.equal(vgg(xv), tv.cuda().features(xv)))
        npz_equal = all(torch.equal(v, via_npz[k])
                        for k, v in vgg.state_dict().items())
        out["vgg19_pth"] = {"bit_equal": equal, "npz_equal": npz_equal}
        if not (equal and npz_equal):
            faults.append(f"VGG19 from torchvision's layout: features "
                          f"bit-equal {equal}, weights of the .npz "
                          f"{npz_equal}")
    print(f"weights (d): {json.dumps(out)} [{smi}]")
    if faults:
        fail("weights: " + "; ".join(faults))
    return out


def phase_tiled_and_weights(smi: str, tiled_runs: dict | None = None
                            ) -> tuple:
    """Halo-tiled inference of a 270 x 250 LR scene (TILED) by the
    full-width x4 flagship (:func:`tiled_flagship`, float32, TF32 off),
    and reference and torchvision weights read without JAX:

    (a) one process on the card: the scene within SLICE_TOL of max|ref| of
    ``tiled_super_resolve`` on the CPU, the launches exactly K1, K2 48 and
    K3 once a chunk;
    (b) the ranks of ``tiled_runs`` (phase_data_parallel's spawns: two gloo
    ranks on this card and, with more cards, one NCCL rank a card; spawned
    here when the phase runs alone): each rank's whole scene bit-equal to
    the others', and to (a)'s or within TOL[float32] of max|ref| (the
    report says which), each rank's launches those of its chunks;
    (c) rank 0 alone against every rank over alternating turns (timed in
    the ranks);
    (d) :func:`_weights_check`.
    Returns the report and (a)'s launches."""
    from sradsgan_tpu_torch.evaluation.tiled import tiled_super_resolve
    from sradsgan_tpu_torch.tools import dp_check

    t_start = time.perf_counter()
    cpu_model = tiled_flagship()
    model = copy.deepcopy(cpu_model).cuda()
    image = dp_check.tiled_scene(TILED["seed"], TILED["height"],
                                 TILED["width"])
    args = (TILED["scale"], TILED["tile"], TILED["halo"],
            TILED["batch_tiles"])
    reset_launches()
    scene = tiled_super_resolve(model, image, *args, device="cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    expected = forward_launches(model, forwards=_tiled_chunks(1))
    if launches != expected:
        fail(f"tiled (a) launched {launches}, not {expected}")
    shape = (TILED["height"] * 4, TILED["width"] * 4, 3)
    if scene.shape != shape or not np.isfinite(scene).all():
        fail(f"tiled (a): scene {scene.shape} (want {shape}), finite="
             f"{np.isfinite(scene).all()}")
    t0 = time.perf_counter()
    ref = tiled_super_resolve(cpu_model, image, *args, device="cpu")
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(scene - ref).max())
    bound = SLICE_TOL * float(np.abs(ref).max())
    print(f"tiled (a) one process, 270 x 250 -> {shape[0]} x {shape[1]}, 25 "
          f"tiles in chunks of 16: launches {launches}; against the CPU "
          f"plain path max|d| {err:.3e} <= {bound:.3e} ({SLICE_TOL:.0e} * "
          f"max|ref|); the CPU took {cpu_s:.1f} s [{smi}]")
    if not err <= bound:
        fail("tiled (a): the card's scene disagrees with the CPU's")
    out = {"card": smi, "one_process": {"launches": launches,
                                        "max_abs_err": err, "bound": bound,
                                        "cpu_s": cpu_s}}
    if tiled_runs is None:
        with tempfile.TemporaryDirectory() as work:
            sc = tiled_scenario(work)
            tiled_runs = {"gloo2": [r["tiled"] for r in dp_check.run_ranks(
                {"device": "cuda:0", "backend": "gloo", "threads": 4,
                 "scenarios": [sc]}, 2, os.path.join(work, "gloo2"),
                DP_DEADLINE_S)]}
            cards = torch.cuda.device_count()
            if cards > 1:
                tiled_runs[f"nccl{cards}"] = [
                    r["tiled"] for r in dp_check.run_ranks(
                        {"device": "cuda", "backend": "nccl", "threads": 4,
                         "scenarios": [sc]}, cards,
                        os.path.join(work, "nccl"), DP_DEADLINE_S)]
    faults = []
    for label, ranks in tiled_runs.items():
        out[label], bad = _hold_tiled_ranks(ranks, scene, model, label, smi)
        faults += bad
    if faults:
        fail("; ".join(faults))
    out["weights"] = _weights_check(smi)
    out["seconds"] = time.perf_counter() - t_start
    print(f"tiled and weights phase: {out['seconds']:.1f} s")
    return out, launches


DATA_TREE = {"classes": 21, "per_class": 20, "size": 256, "seed": 14}
DATA_CROP, DATA_SCALE, DATA_BATCH, DATA_STEPS = 216, 4, 16, 2
DATA_FEED_BATCHES = 4   # batches read per dataset for its images/s
GDP_BATCH = 4
SRMD = {"batch": 16, "size": 216, "kernel": 21, "scale": 4, "noise": 0.01}
SRMD_TOL = 1e-5         # absolute, card against the CPU composition
SRMD_KERNEL_TOL = 1e-6  # absolute, card kernels against the CPU's
SCENE_CHECK_IMAGES = 8
SCENE_TOL = 1e-4        # of max|ref|, card features against the CPU's


class DictEnv:
    """lmdb's ``begin()`` transaction interface over a dict of records."""

    def __init__(self, store: dict):
        self.store = store

    @contextlib.contextmanager
    def begin(self, write: bool = False):
        yield types.SimpleNamespace(get=self.store.get)


def make_class_tree(root: str) -> list:
    """A UCMerced-shaped tree from DATA_TREE's seed: ``classes`` folders of
    ``per_class`` ``size``^2 pngs, each a class colour under smooth and
    fine random texture (so that a random VGG16 trunk still separates the
    classes); returns the files."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    t = DATA_TREE
    rng = np.random.default_rng(t["seed"])
    colours = rng.uniform(40, 215, (t["classes"], 3))
    jobs = []
    for c in range(t["classes"]):
        folder = os.path.join(root, f"class{c:02d}")
        os.makedirs(folder)
        for i in range(t["per_class"]):
            coarse = rng.normal(0, 30, (8, 8, 3))
            fine = rng.normal(0, 12, (t["size"], t["size"], 3))
            jobs.append((os.path.join(folder, f"{i:03d}.png"), colours[c],
                         coarse, fine))

    def write(job):
        path, colour, coarse, fine = job
        up = np.kron(coarse, np.ones((t["size"] // 8, t["size"] // 8, 1)))
        arr = np.clip(colour + up + fine, 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(path)
        return path

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(write, jobs))


def _srmd_check(smi: str) -> dict:
    """(a) ``srmd_preprocess`` at SRMD's sizes on the card, isotropic and
    anisotropic.  Its uniform draws (sigma_x, then sigma_y and theta when
    anisotropic) and its noise are replayed from a second generator of the
    seed and moved to the CPU; the card's kernels are held to the CPU's
    ``gaussian_kernels_from`` of those draws within SRMD_KERNEL_TOL, and
    its LR to the CPU composition (``srmd_preprocess_from``) within
    SRMD_TOL.  ms a call (draws included) by CUDA events."""
    from sradsgan_tpu_torch.ops import degrade

    s = SRMD
    b = s["batch"]
    hr = torch.rand((b, s["size"], s["size"], 3), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    out = {}
    for iso in (True, False):
        label = "isotropic" if iso else "anisotropic"

        def call(seed=1):
            return degrade.srmd_preprocess(
                torch.Generator("cuda").manual_seed(seed), hr, s["scale"],
                s["kernel"], 4.0, s["noise"], isotropic=iso)

        lr, kernels = call()
        replay = torch.Generator("cuda").manual_seed(1)
        u = [torch.rand((b,), generator=replay, device="cuda").cpu()
             for _ in range(1 if iso else 3)]
        sigma_x = 0.2 + 3.8 * u[0]
        if iso:
            sigma_y, theta = sigma_x, torch.zeros_like(sigma_x)
        else:
            sigma_y, theta = 0.2 + 3.8 * u[1], math.pi * u[2]
        k_ref = degrade.gaussian_kernels_from(sigma_x, sigma_y, theta,
                                              s["kernel"])
        lr_size = s["size"] // s["scale"]
        noise = torch.randn((b, lr_size, lr_size, 3), generator=replay,
                            device="cuda")
        k_err = float((kernels.cpu() - k_ref).abs().max())
        if not k_err <= SRMD_KERNEL_TOL:
            fail(f"srmd {label}: card kernels differ from the CPU's by "
                 f"{k_err:.3e} > {SRMD_KERNEL_TOL:.0e}")
        ref = degrade.srmd_preprocess_from(hr.cpu(), k_ref, s["scale"],
                                           noise.cpu(), s["noise"])
        err = float((lr.cpu() - ref).abs().max())
        for _ in range(3):
            call()
        ms = _event_ms(lambda: [call() for _ in range(20)], 20)
        out[label] = {"max_abs_err": err, "kernel_max_abs_err": k_err,
                      "ms": ms, "lr_shape": list(lr.shape)}
        print(f"srmd_preprocess {label} {b} x {s['size']}^2 x3, "
              f"{s['kernel']}^2 kernels, x{s['scale']}, noise "
              f"{s['noise']}: card vs CPU of the same draws, kernels "
              f"max|d| {k_err:.3e} <= {SRMD_KERNEL_TOL:.0e}, LR max|d| "
              f"{err:.3e} <= {SRMD_TOL:.0e}; {ms:.3f} ms a call [{smi}]")
        if not (err <= SRMD_TOL and lr.shape == (b, lr_size, lr_size, 3)):
            fail(f"srmd {label}: the card disagrees with the CPU")
    return out


def _feed_train(files: list, smi: str) -> tuple:
    """(b) each dataset variant at crop DATA_CROP, x4, through the
    ``DataLoader`` at DATA_BATCH with ``augment_rng``: its host images/s
    over DATA_FEED_BATCHES batches, then DATA_STEPS float32 unfused
    flagship steps on its first batches, with finite losses and exactly the
    step's launches (:func:`step_launches`) in each step the host launches
    (the eager and captured ones; a replayed step launches from its
    graph)."""
    from sradsgan_tpu_torch.data import datasets as ds

    scale = DATA_SCALE
    variants = {
        "folder_augment": ds.FolderDataset(files, scale, DATA_CROP,
                                           augment=True),
        "augmented_crop": ds.AugmentedCropDataset(files, scale, DATA_CROP),
        "noisy_gaussian": ds.NoisyDataset(files, scale, DATA_CROP,
                                          noise="gaussian"),
        "noisy_sp": ds.NoisyDataset(files, scale, DATA_CROP, noise="sp"),
        "noisy_poisson": ds.NoisyDataset(files, scale, DATA_CROP,
                                         noise="poisson"),
        "blur": ds.BlurDegradedDataset(files, scale, DATA_CROP),
    }
    trainer = make_trainer("f32")
    per_step = step_launches(trainer)
    out, paths = {}, {}
    for name, dataset in variants.items():
        loader = DataLoader(dataset, DATA_BATCH, shuffle=True, seed=0,
                            augment_rng=True)
        it = iter(loader)
        t0 = time.perf_counter()
        batches = [next(it) for _ in range(DATA_FEED_BATCHES)]
        host_s = time.perf_counter() - t0
        it.close()
        lr_size = DATA_CROP // scale
        if (batches[0]["lr"].shape != (DATA_BATCH, lr_size, lr_size, 3)
                or batches[0]["hr"].shape != (DATA_BATCH, DATA_CROP,
                                              DATA_CROP, 3)):
            fail(f"{name}: batch shapes {batches[0]['lr'].shape}, "
                 f"{batches[0]['hr'].shape}")
        # each variant's steps an eager one and a capture, both launched
        # by the host
        trainer._drop_graph()
        reset_launches()
        kinds = dict(trainer.graph_stats)
        losses = []
        for batch in batches[:DATA_STEPS]:
            metrics = trainer.train_step({"lr": batch["lr"],
                                          "hr": batch["hr"]})
            losses.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        launches = read_launches()
        called = sum(trainer.graph_stats[k] - kinds[k]
                     for k in ("eager", "captured"))
        if called != DATA_STEPS:
            fail(f"{name}: {called} of {DATA_STEPS} steps launched by the "
                 f"host")
        want = {k: called * v for k, v in per_step.items()}
        paths[f"train_{name}"] = launches
        ips = DATA_FEED_BATCHES * DATA_BATCH / host_s
        out[name] = {"host_images_per_s": ips, "losses": losses}
        print(f"{name}: {ips:.1f} host images/s (loader, {DATA_CROP}^2 x"
              f"{scale}, batch {DATA_BATCH}); {DATA_STEPS} f32 flagship "
              f"steps ({called} launched by the host), loss_G "
              f"{[round(x['loss_G'], 5) for x in losses]}, launches "
              f"{launches} [{smi}]")
        if launches != want:
            fail(f"{name}: {called} host-launched steps launched "
                 f"{launches}, not {want}")
        if not all(np.isfinite(list(x.values())).all() for x in losses):
            fail(f"{name}: losses are not finite: {losses}")
    del trainer
    torch.cuda.empty_cache()
    return out, paths


def _feed_diffusion(src: str, work: str, smi: str) -> dict:
    """(c) GDP's layouts: ``prepare_triplets`` of the tree at 216/54 feeds
    ``TripletFolderDataset(hflip=True)``, and ``iter_triplet_records`` of
    its first class folder (a generator on one thread: 20 images) a
    dict-backed env that feeds ``LMDBTripletDataset(hflip=True)``; each
    DATA_STEPS float32 ``DiffusionTrainer`` steps at batch GDP_BATCH of
    216^2 at the shipped width, finite, with no kernel launched."""
    from sradsgan_tpu_torch.data import datasets as ds
    from sradsgan_tpu_torch.diffusion.config import (
        load_gdp_config, trainer_kwargs_from_config)
    from sradsgan_tpu_torch.diffusion.trainer import DiffusionTrainer
    from sradsgan_tpu_torch.tools.prepare_data import (iter_triplet_records,
                                                       prepare_triplets)

    lr_size = DATA_CROP // DATA_SCALE
    trip = os.path.join(work, "triplets")
    t0 = time.perf_counter()
    n = prepare_triplets(src, trip, DATA_CROP, lr_size)
    prep_s = time.perf_counter() - t0
    first = os.path.join(src, sorted(os.listdir(src))[0])
    t0 = time.perf_counter()
    store = dict(iter_triplet_records(first, DATA_CROP, lr_size))
    rec_s = time.perf_counter() - t0
    n_rec = int(store[b"length"])
    out = {"prepare_triplets_images_per_s": n / prep_s,
           "iter_triplet_records_images_per_s": n_rec / rec_s}
    print(f"prepare_triplets: {n} images at {DATA_CROP}/{lr_size} in "
          f"{prep_s:.2f} s = {n / prep_s:.1f} images/s; iter_triplet_records"
          f" {n_rec} images, {n_rec / rec_s:.1f} images/s [{smi}]")
    kwargs = trainer_kwargs_from_config(load_gdp_config(DIFFUSION_CONFIG))
    layouts = {"triplet_folder": ds.TripletFolderDataset(
                   trip, lr_size, DATA_CROP, hflip=True),
               "lmdb": ds.LMDBTripletDataset(DictEnv(store), lr_size,
                                             DATA_CROP, hflip=True)}
    data_cfg = DataConfig(synthetic=True, crop_size=DATA_CROP,
                          batch_size=GDP_BATCH)
    for name, dataset in layouts.items():
        with tempfile.TemporaryDirectory() as save_dir:
            trainer = DiffusionTrainer(
                data_cfg, kwargs["scale"], save_dir=save_dir,
                unet_kwargs=kwargs["unet_kwargs"], bf16=False,
                device="cuda")
        gen = torch.Generator("cuda").manual_seed(1)
        loader = iter(DataLoader(dataset, GDP_BATCH, shuffle=True, seed=0,
                                 augment_rng=True))
        reset_launches()
        losses = []
        for _ in range(DATA_STEPS):
            batch = next(loader)
            losses.append(float(trainer.train_step(
                {"HR": 2.0 * batch["hr"] - 1.0, "SR": 2.0 * batch["bc"] - 1.0},
                gen)))
        loader.close()
        launches = read_launches()
        out[name] = {"losses": losses, "launches": launches}
        print(f"diffusion from {name}: {DATA_STEPS} f32 steps at batch "
              f"{GDP_BATCH} x {DATA_CROP}^2, losses "
              f"{[round(x, 5) for x in losses]}, launches {launches} "
              f"[{smi}]")
        if any(launches.values()) or not np.isfinite(losses).all():
            fail(f"diffusion from {name}: launches {launches}, losses "
                 f"{losses}")
        del trainer
        torch.cuda.empty_cache()
    return out


def _scene_head_times(clf, x: np.ndarray, y: np.ndarray, num_classes: int,
                      smi: str, steps: int = 50) -> dict:
    """Where the head's ``steps`` full-batch Adam steps spend their time:
    the host's draw of the initial head (``init_head``), then ``fit_head``
    from that head three times: cold (its first call; it also copies the
    head to the card), warm, and warm under ``torch.profiler`` for the
    device's busy ms (the sum of its kernel times, one stream).  FLOPs a
    step: the forward and dW of both layers, and dH of the second
    (the features need no gradient): 4 n dim 256 + 6 n 256 K."""
    from torch.profiler import ProfilerActivity, profile

    n, dim = x.shape
    flop = steps * (4 * n * dim * 256 + 6 * n * 256 * num_classes)
    t0 = time.perf_counter()
    start = clf.init_head(dim, num_classes)
    init_ms = (time.perf_counter() - t0) * 1e3
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = clf.fit_head(x, y, num_classes, steps, head=start)
        walls.append((time.perf_counter() - t0) * 1e3)  # reads the loss
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        clf.fit_head(x, y, num_classes, steps, head=start)
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    out = {"head_ms": init_ms + walls[0], "head_init_ms": init_ms,
           "head_cold_ms": walls[0], "head_warm_ms": walls[1],
           "head_busy_ms": busy_ms, "head_gflop": flop / 1e9,
           "head_tflops_busy": flop / busy_ms / 1e9 if busy_ms else None,
           "train_loss": loss}
    print(f"scene head {steps} Adam steps on {n} x {dim} features, "
          f"{flop / 1e9:.1f} GFLOP: host init {init_ms:.1f} ms, cold "
          f"{walls[0]:.1f} ms, warm "
          f"{walls[1]:.1f} ms wall, device busy {busy_ms:.1f} ms "
          f"({flop / walls[1] / 1e9:.2f} TFLOP/s of the warm wall, "
          f"{out['head_tflops_busy'] or 0:.2f} of the busy time; float32 "
          f"peak 67) [{smi}]")
    return out


def _scene(root: str, files: list, work: str, smi: str) -> dict:
    """(d) ``SceneClassifier(image_size=216)`` on the card: feature
    images/s over the tree, the head's 50 Adam steps in ms, its accuracy
    over the tree by ``evaluate_folder``; SCENE_CHECK_IMAGES images'
    features against the CPU's (the same seeded trunk)."""
    from sradsgan_tpu_torch.tools.scene_classification import (
        SceneClassifier, split_dataset)

    clf = SceneClassifier(image_size=DATA_CROP, device="cuda")
    clf.features(files[:clf.feature_batch])  # warm-up
    t0 = time.perf_counter()
    feats = clf.features(files)
    feat_s = time.perf_counter() - t0
    ref = SceneClassifier(image_size=DATA_CROP, device="cpu").features(
        files[:SCENE_CHECK_IMAGES])
    err = float(np.abs(feats[:SCENE_CHECK_IMAGES] - ref).max())
    bound = SCENE_TOL * float(np.abs(ref).max())
    splits, classes = split_dataset(root)
    row = {f: i for i, f in enumerate(files)}
    x = feats[[row[f] for f, _ in splits["train"]]]
    y = np.array([label for _, label in splits["train"]])
    head = _scene_head_times(clf, x, y, len(classes), smi)
    result = clf.evaluate_folder(root, os.path.join(work, "confusion.png"))
    out = {"features": list(feats.shape), "pretrained": clf.pretrained,
           "feature_images_per_s": len(files) / feat_s, **head,
           "accuracy": result["accuracy"], "max_abs_err": err,
           "bound": bound}
    loss = head["train_loss"]
    trunk = "pretrained" if clf.pretrained else "seeded"
    print(f"scene classification ({trunk} VGG16 trunk, {DATA_CROP}^2 -> "
          f"{feats.shape[1]} "
          f"features): {len(files) / feat_s:.1f} feature images/s, head 50 "
          f"Adam steps {head['head_ms']:.1f} ms (loss {loss:.4f}), accuracy "
          f"over the tree {result['accuracy']:.4f}; {SCENE_CHECK_IMAGES} "
          f"images' features card vs CPU max|d| {err:.3e} <= {bound:.3e} "
          f"[{smi}]")
    if feats.shape != (len(files), 6 * 6 * 512) or not err <= bound:
        fail("scene classification: features disagree with the CPU's")
    if (np.sum(result["confusion"]) != len(files)
            or not np.isfinite(loss)):
        fail(f"scene classification: {result}, loss {loss}")
    return out


def _dry_run(smi: str) -> tuple:
    """(e) ``entry()``'s forward on the card (both gains 0.5) against its
    CPU twin on a random 54^2 image, launches exact; then
    ``dryrun_multichip`` over every card's NCCL rank."""
    from sradsgan_tpu_torch.tools.dryrun import dryrun_multichip, entry

    forward, (model, zeros) = entry()
    _, (cpu_model, _) = entry(device="cpu")
    for m in (model, cpu_model):
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith(("ca.gamma", "sa.gamma")):
                    p.fill_(0.5)
    x = torch.from_numpy(np.random.default_rng(4).random(
        (1, 3, 54, 54), dtype=np.float32))
    reset_launches()
    got = forward(model, x.cuda())
    torch.cuda.synchronize()
    launches = read_launches()
    ref = forward(cpu_model, x)
    err = float((got.cpu() - ref).abs().max())
    bound = SLICE_TOL * float(ref.abs().max())
    if launches != forward_launches(model) or zeros.shape != (1, 3, 54, 54):
        fail(f"entry: launches {launches}, not {forward_launches(model)}")
    print(f"entry() forward 1 x 54^2 -> {tuple(got.shape)}: card vs CPU "
          f"max|d| {err:.3e} <= {bound:.3e}; launches {launches} [{smi}]")
    if not err <= bound:
        fail("entry: the card's forward disagrees with the CPU's")
    cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    dry = dryrun_multichip(cards)
    seconds = time.perf_counter() - t0
    print(f"dryrun_multichip({cards}) over NCCL: {seconds:.1f} s [{smi}]")
    return ({"entry": {"max_abs_err": err, "bound": bound},
             "dryrun": {"cards": cards, "seconds": seconds, **dry}},
            launches)


def phase_data_and_tools(smi: str) -> tuple:
    """The data variants and the offline tools on the card, at full size:
    (a) :func:`_srmd_check`; on a UCMerced-shaped tree
    (:func:`make_class_tree`), (b) :func:`_feed_train`, (c)
    :func:`_feed_diffusion`, (d) :func:`_scene`; (e) :func:`_dry_run`.
    Returns the report and the launches of each path it drove."""
    t_start = time.perf_counter()
    out = {"card": smi, "srmd": _srmd_check(smi)}
    with tempfile.TemporaryDirectory() as work:
        root = os.path.join(work, "ucmerced")
        t0 = time.perf_counter()
        files = make_class_tree(root)
        out["tree_s"] = time.perf_counter() - t0
        out["train_feeds"], paths = _feed_train(files, smi)
        out["diffusion_feeds"] = _feed_diffusion(root, work, smi)
        out["scene"] = _scene(root, files, work, smi)
    out["dry_run"], paths["entry"] = _dry_run(smi)
    out["seconds"] = time.perf_counter() - t_start
    print(f"data and tools phase: {out['seconds']:.1f} s")
    return out, paths


def main() -> int:
    # Full float32 in the plain versions too: cuDNN would run the float32
    # convs in TF32 (about three decimal digits) by default.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_device()
    phase_build()
    plans = phase_plans()
    record = phase_kernels()
    big = record["position_attention"]["cases"]
    serving = phase_serving(smi, {
        torch.float32: big["float32 1x46656x8x64"]["ms"],
        torch.bfloat16: big["bfloat16 1x46656x8x64"]["ms"]})
    correctness = {"unfused": phase_train_correctness("unfused")}
    correctness["fused"] = phase_train_correctness(
        "fused", correctness["unfused"].pop("card"))
    validation = phase_validation_batch()
    timing = phase_train_timing(smi)
    cli_train = phase_cli_train(smi)
    eval_protocol = phase_eval_protocol(smi)
    zoo = phase_model_zoo(smi)
    grammar = phase_attention_grammar(smi)
    hat = phase_hat(smi)
    exported = phase_export(smi)
    diffusion = phase_diffusion(smi)
    data_parallel, nccl1, gloo2, tiled_runs = phase_data_parallel(smi)
    tiled, tiled_launches = phase_tiled_and_weights(smi, tiled_runs)
    data_tools, data_paths = phase_data_and_tools(smi)
    paths = {"serving": serving["launches"],
             "serving_fused": serving["fused_launches"],
             **{f"train_{k[len('launches_'):]}": v
                for k, v in timing.items() if k.startswith("launches_")},
             "cli_train_fused": cli_train["launches"],
             **eval_protocol.pop("launches_by_path"),
             **zoo.pop("launches_by_path"),
             **grammar.pop("launches_by_path"),
             "train_ddp_nccl1": nccl1, "train_ddp_gloo2": gloo2,
             "tiled_one_process": tiled_launches,
             **{f"tiled_{k}_rank0": v["launches_rank0"]
                for k, v in tiled.items() if k.startswith(("gloo", "nccl"))},
             **data_paths}
    never = [name for name in KERNELS
             if not any(path[name] for path in paths.values())]
    idle = [name for name in KERNELS if not cli_train["launches"][name]]
    if never or idle:
        fail(f"kernels never launched on any path: {never}; not launched by "
             f"the training entry point: {idle}")
    kernels = [{"name": name, "route": "cuda", "source": spec["source"],
                "replaces": spec["replaces"],
                "launches": cli_train["launches"][name],
                "launches_by_path": {k: v[name] for k, v in paths.items()},
                **record[name]}
               for name, spec in KERNELS.items()]
    print(json.dumps({"kernels": kernels, "serving": serving["serving"],
                      "train": {k: v for k, v in timing.items()
                                if not k.startswith("launches")},
                      "train_grad_check": {rab: c["grad_check"] for rab, c
                                           in correctness.items()},
                      "validation_batch": validation,
                      "cli_train": {k: v for k, v in cli_train.items()
                                    if k != "launches"},
                      "eval_protocol": eval_protocol, "model_zoo": zoo,
                      "attention_grammar": grammar, "hat": hat, "export": exported,
                      "diffusion": diffusion,
                      "data_parallel": data_parallel,
                      "tiled_and_weights": tiled,
                      "data_and_tools": data_tools, "strips": plans,
                      "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
