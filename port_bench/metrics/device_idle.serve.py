"""Percent of the untraced window in which the card runs nothing, worked
out from the trace: the device's busy seconds an output pixel in the
traced segment (one block of the deck, every request shape in the mix's
proportions) times the window's output pixels, against the window's
seconds.  The traced segment's own idle share counts the profiler's host
overhead too."""


def read(ctx):
    m = ctx["measured"]
    if not m.get("out_pixels") or not m.get("traced_lr_pixels"):
        return None
    scale2 = ctx["cell"].config["scale"] ** 2
    per_pixel = m["busy_s"] / (sum(m["traced_lr_pixels"]) * scale2)
    return 100.0 * (1.0 - per_pixel * m["out_pixels"] / m["window_s"])
