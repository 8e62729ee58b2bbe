"""Percent of the traced requests' device time that HAT's attention takes:
the device operations launched inside the spans ``hat.window_attention``
and ``hat.overlap_attention`` (each linked to its launching host call by
the trace's correlation id) over every device operation of the traced
segment (``port_bench/attention.py``).  Nothing where the program opens
no such span."""

from port_bench import attention


def read(ctx):
    under, total = attention.device_s(ctx["trace"])
    if under <= 0 or total <= 0:
        return None
    return 100.0 * under / total
