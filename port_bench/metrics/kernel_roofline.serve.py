"""Percent: as ``kernel_roofline.train``, over the forward ops a request
launches (pool, spatial gate, position attention and, where fused, the RAB
tail)."""

from port_bench import roofline, trace


def read(ctx):
    calls = trace.op_calls(ctx["trace"], "sradsgan_tpu_torch::")
    mhz = float(ctx["card"].get("max_sm_mhz") or 1980)
    return roofline.roofline_share(calls, roofline.FORWARD_OPS, mhz)
