"""Percent: the least time of a step's work in the program's six kernel
functions (``roofline.OPS``), each call's from its shapes and the
published peaks, times the traced steps, over the device time of the
program's own kernels in the traced window.  The step's calls are read
off the check's first reference step (``schedule.py``), and the kernels
are found by name (``trace.kernel_s``), so the share reads the same
whether the step's kernels are launched eagerly or replayed in a CUDA
graph."""

from port_bench import roofline, trace


def read(ctx):
    m = ctx["measured"]
    if not m.get("schedule") or not m.get("traced_steps"):
        return None
    mhz = float(ctx["card"].get("max_sm_mhz") or 1980)
    bound = m["traced_steps"] * roofline.schedule_bound_s(m["schedule"], mhz)
    return roofline.share(bound, trace.kernel_s(ctx["trace"]))
