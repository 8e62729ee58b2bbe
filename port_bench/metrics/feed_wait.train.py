"""Percent of the window's wall time that the training loop waited on the
program's feed (``DataLoader`` -> ``device_prefetch``): the benchmark's
host clock around each ``next()``, over the untraced window."""


def read(ctx):
    m = ctx["measured"]
    if "feed_wait_s" not in m or m["window_s"] <= 0:
        return None
    return 100.0 * m["feed_wait_s"] / m["window_s"]
