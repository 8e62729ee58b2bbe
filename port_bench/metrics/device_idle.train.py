"""Percent of the untraced window in which the card runs nothing, worked
out from the trace: the device's busy seconds a step in the traced segment
(the union of kernel, copy and set intervals on every stream) times the window's steps, against the window's seconds.
The traced segment's own idle share (``device.busy_s`` against
``device.window_s``) counts the profiler's host overhead too."""


def read(ctx):
    m = ctx["measured"]
    if not m.get("steps") or not m.get("traced_steps"):
        return None
    busy = m["busy_s"] / m["traced_steps"] * m["steps"]
    return 100.0 * (1.0 - busy / m["window_s"])
