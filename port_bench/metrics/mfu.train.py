"""Percent of the chips' published dense bf16 peak (989 TFLOP/s a card)
that the whole train step reaches over the untraced window: the model's
FLOPs a step (``FlopCounterMode`` over the plain reference step at the
cell's global batch) times the steps, over the window's seconds times the
cell's chips."""

PEAK_FLOPS = 989e12


def read(ctx):
    m = ctx["measured"]
    if not m.get("flops_per_step") or not m.get("steps"):
        return None
    return (100.0 * m["flops_per_step"] * m["steps"]
            / (m["window_s"] * ctx["chips"] * PEAK_FLOPS))
