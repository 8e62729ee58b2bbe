"""Percent: as ``kernel_roofline.train``, over the traced requests: each
request's calls (pool, spatial gate, position attention) at the shape it
runs at on the device, read off the reference generator's forward
(``schedule.request``)."""

from port_bench import roofline, schedule, trace


def read(ctx):
    shapes = ctx["measured"].get("traced_shapes")
    if not shapes:
        return None
    config = ctx["cell"].config
    mhz = float(ctx["card"].get("max_sm_mhz") or 1980)
    bound = sum(roofline.schedule_bound_s(schedule.request(config, b, s), mhz)
                for b, s in shapes)
    return roofline.share(bound, trace.kernel_s(ctx["trace"]))
