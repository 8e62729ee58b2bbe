"""Percent: the summed least times of the program's registered ops
(``torch.ops.sradsgan_tpu_torch.*``, all six) in the traced window, each
from its input shapes and the published peaks, over the summed device time
of the kernels those calls launched."""

from port_bench import roofline, trace


def read(ctx):
    calls = trace.op_calls(ctx["trace"], "sradsgan_tpu_torch::")
    mhz = float(ctx["card"].get("max_sm_mhz") or 1980)
    return roofline.roofline_share(calls, roofline.OPS, mhz)
