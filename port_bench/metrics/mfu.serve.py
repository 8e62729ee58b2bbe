"""Percent of the card's published TF32 peak (495 TFLOP/s, the highest
rate any float32 implementation could reach) that serving reaches over the
untraced window: each request's FLOPs at its own unpadded shape
(``FlopCounterMode`` over the plain reference generator), summed, over the
window's seconds."""

from port_bench.flops import forward_flops

PEAK_FLOPS = 495e12


def read(ctx):
    m = ctx["measured"]
    shapes = m.get("request_shapes")
    if not shapes:
        return None
    config = ctx["cell"].config
    total = sum(forward_flops(config, k, h, w) for k, h, w in shapes)
    return 100.0 * total / (m["window_s"] * PEAK_FLOPS)
