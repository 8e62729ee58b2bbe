"""The row-strip kernels (K2 gate forward, K4 gate backward, K6 fused RAB
tail) at the main path's shapes: errors against float64, device times in
the L2 and cold.

    python -m sradsgan_tpu_torch.tools.strip_probe [--only k2|k4|k6]
        [--batches 16 4 1] [--no-time] [--k2-rows 0 1 2] [--csrc DIR]

K2 at (B, 64, 54, 54) for each batch size, the discriminator's
(16, 256, 27, 27), a ragged (3, 64, 27, 31) and one 216^2 image: the output
against the plain version in float64, a second call for equal bits, then
its time beside its byte bound (x read once, out written once); at each
strip height ``--k2-rows`` names.  ``--csrc`` builds the kernels from a
copy of ``csrc/`` that holds another design of one of them behind the same
C interface, so that it is timed by the same code.

K4 at (16, 64, 54, 54), (16, 256, 27, 27) and a ragged (3, 64, 27, 31): dx
and dw against the plain version in float64, a second call for equal bits,
then the time of the whole op, of the kernel without its dw stage, and of
the plain dw contraction from the stat planes (one ``torch.stack`` and one
cuDNN weight-gradient call, what the plain path runs).  K6 at
(B, 64, 54, 54) for each batch size and at the ragged shape: the seven
outputs against float64, the maxima exact, a second call for equal bits,
then its time beside the unfused composition's (pool kernel, MLP, gate
kernel, cuDNN 1x1 conv, add).
Times are device ms per call, a replayed CUDA graph of 20 calls; "cold"
rotates the inputs over four times the L2 so that each call reads device
memory, as in the model.  This is the script to rerun after a change to
either kernel, before the whole smoke run.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import itertools
import subprocess
from pathlib import Path

import torch

from sradsgan_tpu_torch.nn.attention import LocalAttention
from sradsgan_tpu_torch.ops import _build, rab_tail, spatial_gate
from sradsgan_tpu_torch.tools.attention_probe import graph_ms

L2_BYTES = 50 * 2 ** 20
PEAK_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _randn(shape, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to("cuda", dtype)


def cold(call, *inputs):
    """``call(*inputs)`` taking its inputs in turn from clones whose total
    is four times the L2 (at most 64 sets)."""
    size = sum(t.numel() * t.element_size() for t in inputs)
    copies = min(max(2, -(-4 * L2_BYTES // size)), 64)
    sets = [tuple(t.clone() for t in inputs) for _ in range(copies)]
    turn = [0]

    def run():
        turn[0] = (turn[0] + 1) % copies
        return call(*sets[turn[0]])
    return run


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def k2_shapes(batches):
    return ([(b, 64, 54, 54) for b in batches]
            + [(16, 256, 27, 27), (3, 64, 27, 31), (1, 64, 216, 216)])


def probe_k2(batches, time_it: bool, rows_list=(0,)) -> None:
    """``rows_list``: strip heights to force on the kernel (0: the plan's)."""
    w = _randn((1, 2, 7, 7), torch.float32, 1, scale=0.3)
    for dtype in (torch.float32, torch.bfloat16):
        for shape, rows in itertools.product(k2_shapes(batches), rows_list):
            if rows > shape[2]:
                continue
            rows = rows or _build.plan("sg_spatial_gate", torch.device(
                "cuda", 0), shape, dtype)["rows"]

            def run(x, rows=rows):
                return spatial_gate.spatial_gate_cuda(x, w, rows)
            x = _randn(shape, dtype, 2)
            got, again = run(x), run(x)
            torch.cuda.synchronize()
            err = _rel(got, spatial_gate.spatial_gate_plain(x.double(),
                                                            w.double()))
            same = torch.equal(got, again)
            line = (f"K2 rows {rows} {str(dtype):<14} "
                    f"{str(shape):<18}: {err:.2e} of "
                    f"max|float64|, two calls "
                    f"{'bit-equal' if same else 'DIFFER'}")
            if err > TOL[dtype] or not same:
                line += "  <-- FAULT"
            if time_it:
                bound = 2 * x.numel() * x.element_size() / PEAK_BYTES_PER_S
                line += (f"; kernel {graph_ms(lambda: run(x)):.4f} (cold "
                         f"{graph_ms(cold(run, x)):.4f}), bound "
                         f"{bound * 1e3:.4f} (bytes)")
            print(line, flush=True)


def probe_k4(time_it: bool) -> None:
    w = _randn((1, 2, 7, 7), torch.float32, 1, scale=0.3)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((16, 64, 54, 54), (16, 256, 27, 27), (3, 64, 27, 31)):
            x, g = _randn(shape, dtype, 2), _randn(shape, dtype, 6)
            dx, dw = spatial_gate.spatial_gate_bwd_cuda(x, w, g)
            again = spatial_gate.spatial_gate_bwd_cuda(x, w, g)
            torch.cuda.synchronize()
            want = spatial_gate.spatial_gate_bwd_plain(
                x.double(), w.double(), g.double())
            errs = (_rel(dx, want[0]), _rel(dw, want[1]))
            same = torch.equal(dx, again[0]) and torch.equal(dw, again[1])
            line = (f"K4 {str(dtype):<14} {shape}: dx {errs[0]:.2e}, dw "
                    f"{errs[1]:.2e} of max|float64|, two launches "
                    f"{'bit-equal' if same else 'DIFFER'}")
            if max(errs) > TOL[dtype] or not same:
                line += "  <-- FAULT"
            if time_it:
                x32 = x.float()
                ds = _randn((shape[0],) + shape[2:], torch.float32, 3)
                mean, mx = x32.mean(1), x32.amax(1)
                runs = {
                    "whole": lambda x, g:
                    spatial_gate.spatial_gate_bwd_cuda(x, w, g),
                    "kernel without dw": lambda x, g:
                    spatial_gate.spatial_gate_bwd_cuda(x, w, g,
                                                       with_dw=False),
                }
                for name, run in runs.items():
                    line += (f"; {name} {graph_ms(lambda: run(x, g)):.4f} "
                             f"(cold {graph_ms(cold(run, x, g)):.4f})")

                def contraction(ds, mean, mx):
                    return spatial_gate.dw_contraction(
                        ds, torch.stack([mean, mx], dim=1), w)
                line += (f"; plain dw contraction "
                         f"{graph_ms(lambda: contraction(ds, mean, mx)):.4f} "
                         f"(cold "
                         f"{graph_ms(cold(contraction, ds, mean, mx)):.4f})")
            print(line, flush=True)


def tail_params(c: int):
    hidden = max(c // 16, 1)
    return (_randn((c, hidden), torch.float32, 11, scale=0.02).abs() + 0.05,
            _randn((hidden, c), torch.float32, 12, scale=0.1),
            _randn((1, 2, 7, 7), torch.float32, 13, scale=0.3),
            _randn((c, c), torch.float32, 14, scale=0.5 / c ** 0.5),
            _randn((c,), torch.float32, 15, scale=0.05))


def unfused_tail(params, dtype):
    """The composition the fused tail replaces, over the same weights."""
    w1, w2, slam_w, fuse_w, fuse_b = params
    la = LocalAttention(fuse_w.shape[0]).to("cuda")
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


def probe_k6(batches, time_it: bool) -> None:
    names = ("out", "gate_c", "gate_s", "mean_u", "max_u", "avg_t", "max_t")
    for dtype in (torch.float32, torch.bfloat16):
        for shape in [(b, 64, 54, 54) for b in batches] + [(3, 64, 27, 31)]:
            t, x_res = _randn(shape, dtype, 8), _randn(shape, dtype, 9)
            params = tail_params(shape[1])
            got = rab_tail.rab_tail_cuda(t, x_res, *params)
            again = rab_tail.rab_tail_cuda(t, x_res, *params)
            torch.cuda.synchronize()
            want = rab_tail.rab_tail_plain(
                t.double(), x_res.double(), *(p.double() for p in params))
            errs = {n: _rel(a, r) for n, a, r in zip(names, got, want)}
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            t32 = t.float()
            exact = (torch.equal(got[6], t32.amax((2, 3))) and torch.equal(
                got[4], (t32 * got[1][:, :, None, None]).amax(1)))
            line = (f"K6 {str(dtype):<14} {shape}: worst "
                    f"{max(errs, key=errs.get)} {max(errs.values()):.2e} of "
                    f"max|float64| (out {errs['out']:.2e}), maxima "
                    f"{'exact' if exact else 'NOT EXACT'}, two launches "
                    f"{'bit-equal' if same else 'DIFFER'}")
            if max(errs.values()) > TOL[dtype] or not (same and exact):
                line += "  <-- FAULT"
            if time_it:
                def fused(t, x_res):
                    return rab_tail.rab_tail_cuda(t, x_res, *params)
                comp = unfused_tail(params, dtype)
                k = graph_ms(lambda: fused(t, x_res))
                kc = graph_ms(cold(fused, t, x_res))
                u = graph_ms(lambda: comp(t, x_res))
                uc = graph_ms(cold(comp, t, x_res))
                line += (f"; kernel {k:.4f} (cold {kc:.4f}), composition "
                         f"{u:.4f} (cold {uc:.4f}), cold ratio "
                         f"{kc / uc:.3f}")
            print(line, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="strip_probe")
    p.add_argument("--only", choices=("k2", "k4", "k6"))
    p.add_argument("--batches", type=int, nargs="+", default=[16, 4, 1])
    p.add_argument("--no-time", action="store_true")
    p.add_argument("--k2-rows", type=int, nargs="+", default=[0],
                   help="strip heights to force on K2 (0: its plan's)")
    p.add_argument("--csrc", help="build the kernels from this directory "
                   "instead (another design of a kernel, behind the same C "
                   "interface)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("strip_probe needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    if args.csrc:
        _build.CSRC_DIR = Path(args.csrc).resolve()
        _build.BUILD_DIR = _build.CSRC_DIR.with_name(
            _build.CSRC_DIR.name + "_build")
    _build.library()
    log = _build.BUILD_DIR / _build.source_hash() / "build.log"
    for line in log.read_text().splitlines():
        if "warning" in line or "spill" in line and " 0 bytes spill" not in line:
            print("build:", line.strip())
    if args.only in (None, "k2"):
        probe_k2(args.batches, not args.no_time, args.k2_rows)
    if args.only in (None, "k4"):
        probe_k4(not args.no_time)
    if args.only in (None, "k6"):
        probe_k6(args.batches, not args.no_time)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
