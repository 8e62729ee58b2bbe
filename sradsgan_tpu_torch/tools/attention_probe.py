"""The attention kernels (K3 forward, K5 backward) over a sweep of batch
sizes, against float64.

    python -m sradsgan_tpu_torch.tools.attention_probe [--n 2916]
        [--batches 1 2 8 12 16 24 32] [--scale 0.5]

For float32 and bfloat16 and each batch size B at (B, N, 8, 64): the
forward's and the backward's worst error over the float64 plain version's
largest value (the float32 plain version's own error beside it), and their
device time per call, a replayed CUDA graph of 20 calls, also scaled to a
batch of 16.  The launch shape changes with B (split keys, 2 or 4 warps a
block, the warpgroup kernels), and a partly filled last wave of blocks
shows as a step in the time per 16: this is the script to rerun after a
change to a kernel's registers or block shape.  ``--scale`` multiplies q
and k (2.0 gives energies of +-30 and more).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse

import torch

from sradsgan_tpu_torch.ops import sgam_flash


def graph_ms(fn, iters: int = 20) -> float:
    """Device ms per call of ``fn``: CUDA events around a replayed graph of
    ``iters`` calls, so the host's launch overhead is not in it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="attention_probe")
    p.add_argument("--n", type=int, default=2916)
    p.add_argument("--batches", type=int, nargs="+",
                   default=[1, 2, 8, 12, 16, 24, 32])
    p.add_argument("--scale", type=float, default=0.5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0))
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    for dtype in (torch.float32, torch.bfloat16):
        for b in args.batches:
            q, k, v, dout = (t.to("cuda", dtype) for t in (
                randn(b, args.n, 8, scale=args.scale),
                randn(b, args.n, 8, scale=args.scale),
                randn(b, args.n, 64), randn(b, args.n, 64)))
            ref = [t.double() for t in (q, k, v, dout)]
            want = sgam_flash.position_attention_plain_chunked(*ref[:3])
            want_bwd = sgam_flash.position_attention_bwd_plain(*ref)
            out, lse = sgam_flash.position_attention_cuda(q, k, v,
                                                          with_lse=True)
            grads = sgam_flash.position_attention_bwd_cuda(q, k, v, out,
                                                           dout, lse)
            plain = sgam_flash.position_attention_plain_chunked(q, k, v)
            plain_bwd = sgam_flash.position_attention_bwd_plain(q, k, v,
                                                                dout)
            fwd_ms = graph_ms(
                lambda: sgam_flash.position_attention_cuda(q, k, v))
            bwd_ms = graph_ms(lambda: sgam_flash.position_attention_bwd_cuda(
                q, k, v, out, dout, lse))
            print(f"{str(dtype):<14} B {b:>3} N {args.n}: forward "
                  f"{fwd_ms:.4f} ms ({fwd_ms * 16 / b:.4f} per 16), err "
                  f"{_rel(out, want):.2e} (plain {_rel(plain, want):.2e}); "
                  f"backward {bwd_ms:.4f} ms ({bwd_ms * 16 / b:.4f} per 16), "
                  f"err {max(map(_rel, grads, want_bwd)):.2e} (plain "
                  f"{max(map(_rel, plain_bwd, want_bwd)):.2e})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
