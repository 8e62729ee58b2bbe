"""Percent: the least time of HAT's attention calls in the traced
requests, each call's from its shapes at the request's device shape (read
off the plain reference's forward on the meta device, a hook on its
``Attend``), the card's memory rate and the serving dtype's peak, over the
device time of the operations launched inside the attention spans
(``port_bench/attention.py``).  Nothing where the program's attention
counters disagree with the reference's calls, or it opens no such span."""

from port_bench import attention


def read(ctx):
    m = ctx["measured"]
    shapes = m.get("traced_shapes")
    if not shapes:
        return None
    config = ctx["cell"].config
    why = attention.counted(config, ctx["cell"].traffic["buckets"], m)
    if why is not None:
        attention.warn(why)
        return None
    under, _ = attention.device_s(ctx["trace"])
    if under <= 0:
        return None
    mhz = float(ctx["card"].get("max_sm_mhz") or 1980)
    dtype = config["precision"]["serve_dtype"]
    bound = sum(attention.bound_s(attention.calls(config, b, s), dtype, mhz)
                for b, s in shapes)
    return 100.0 * bound / under
