"""The arithmetic on a trace, on a synthetic one: the union of device
intervals over streams (not their sum), the idle gaps and what the host
did in them, the ops' device time and roofline share, the padding."""

import pytest

from port_bench import roofline, trace


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1 if cat in trace.HOST_CATEGORIES else 0, "tid": tid,
            "args": args}


def synthetic():
    events = [
        ev("user_annotation", trace.WINDOW_SPAN, 0, 100),
        ev("user_annotation", "bench.request", 0, 60),
        ev("cpu_op", "aten::conv2d", 2, 3, **{"Input Dims": [[2, 3, 8, 8], [4, 3, 3, 3]]}),
        ev("cpu_op", "aten::conv2d", 6, 3, **{"Input Dims": [[2, 4, 8, 8], [4, 4, 3, 3]]}),
        ev("cpu_op", "sradsgan_tpu_torch::avg_max_pool", 10, 5,
           **{"Input Dims": [[16, 64, 54, 54]], "Input type": ["float"],
              "External id": 7}),
        ev("cpu_op", "aten::item", 40, 20),
        ev("user_annotation", "bench.request", 70, 18),
        ev("cpu_op", "aten::conv2d", 71, 3, **{"Input Dims": [[1, 3, 12, 12]]}),
        # device: two streams overlapping, a copy, one before the window
        ev("kernel", "conv_kernel", 10, 20, tid=7),
        ev("kernel", "pool_kernel", 15, 10, tid=8, **{"External id": 7}),
        ev("gpu_memcpy", "Memcpy HtoD", 28, 4, tid=9),
        ev("kernel", "ncclDevKernel_AllReduce", 70, 10, tid=10),
        ev("kernel", "early", -20, 25, tid=7),
    ]
    return trace.from_events(events)


def test_busy_is_the_union_not_the_sum():
    tr = synthetic()
    # [-20, 5) clipped to [0, 5), [10, 32), [70, 80): 5 + 22 + 10
    assert tr.window_s == pytest.approx(100e-6)
    assert trace.busy_s(tr) == pytest.approx(37e-6)
    assert trace.busy_s(tr, lambda n: "nccl" in n.lower()) == pytest.approx(
        10e-6)


def test_idle_gaps_and_what_the_host_did():
    tr = synthetic()
    assert trace.idle_gaps(tr) == [(5, 10), (32, 70), (80, 100)]
    bd = trace.breakdown(tr)
    gaps = dict(bd["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(38e-6)  # mid 51 in aten::item
    assert gaps["aten::conv2d"] == pytest.approx(5e-6)  # mid 7.5
    assert gaps[trace.WINDOW_SPAN] == pytest.approx(20e-6)  # mid 90
    ops = dict(bd["device_ops"])
    assert ops["conv_kernel"] == pytest.approx(20e-6)
    assert ops["early"] == pytest.approx(5e-6)  # only its part in the window


def test_op_calls_link_their_kernels():
    calls = trace.op_calls(synthetic(), "sradsgan_tpu_torch::")
    assert calls == [{"name": "avg_max_pool", "dims": [[16, 64, 54, 54]],
                      "types": ["float"], "concrete": [],
                      "device_s": pytest.approx(10e-6), "kernels": 1}]
    share = roofline.roofline_share(calls, roofline.OPS, 1980)
    n = 16 * 64 * 54 * 54
    bound = (n + 2 * 16 * 64) * 4 / roofline.PEAK_BYTES_PER_S
    assert share == pytest.approx(100 * bound / 10e-6)
    assert roofline.roofline_share([], roofline.OPS, 1980) is None


def test_bounds_of_the_attention():
    # K3 at the train step's shape: 2 B N^2 (8 + 64) products in bf16 and
    # B N^2 exponentials; the larger term bounds it
    dims = [[16, 2916, 8], [16, 2916, 8], [16, 2916, 64], []]
    c = roofline.counts("position_attention", dims, 2)
    assert c["flops"] == 2 * 16 * 2916 ** 2 * 72
    assert c["exps"] == 16 * 2916 ** 2
    rate = roofline.exps_rate(1980)
    b = roofline.bound_s("position_attention", dims, ["c10::BFloat16"], rate)
    assert b == pytest.approx(max(c["exps"] / rate,
                                  c["flops"] / roofline.PEAK_FLOPS["bfloat16"]))
