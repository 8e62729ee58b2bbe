"""The arithmetic on a trace, on a synthetic one: the union of device
intervals over streams (not their sum), the idle gaps and what the host
did in them, the ops' device time and roofline share, eager and replayed
from a CUDA graph."""

import pytest

from port_bench import roofline, trace
from port_bench.schedule import Entry

PREFIX = "sradsgan_tpu_torch::"
POOL = ("void (anonymous namespace)::avg_max_pool_kernel<float>(float "
        "const*, float*, float*, int)")
GATE = ("void (anonymous namespace)::gate_kernel<float, 0>(float const*, "
        "float const*, float*, float*, sg::strip::Geom)")
X = [16, 64, 54, 54]


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
    share = roofline.roofline_share(calls, 1980)
    n = 16 * 64 * 54 * 54
    bound = (n + 2 * 16 * 64) * 4 / roofline.PEAK_BYTES_PER_S
    assert share == pytest.approx(100 * bound / 10e-6)
    assert roofline.roofline_share([], 1980) is None


def six_op_trace(graph: bool):
    """Two steps, each a pool and a gate and a library conv: launched
    eagerly (host op calls, their kernels linked by External id) or
    replayed from a CUDA graph (one cudaGraphLaunch a step, no op call,
    kernels with no External id)."""
    events = [ev("user_annotation", trace.WINDOW_SPAN, 0, 200)]
    ext = 0
    for t0 in (0, 100):
        if graph:
            events.append(ev("cuda_runtime", "cudaGraphLaunch", t0 + 1, 5))
        for kernel, op, dims, types, t, dur in (
                (POOL, "avg_max_pool", [X], ["float"], 10, 8),
                (GATE, "spatial_gate", [X, [1, 2, 7, 7], []],
                 ["float", "float", ""], 30, 12)):
            ext += 1
            link = {} if graph else {"External id": ext}
            if not graph:
                events.append(ev("cpu_op", PREFIX + op, t0 + t - 8, 3,
                                 **{"Input Dims": dims, "Input type": types},
                                 **link))
            events.append(ev("kernel", kernel, t0 + t, dur, tid=7, **link))
        events.append(ev("kernel", "sm90_xmma_fprop_implicit_gemm", t0 + 50,
                         20, tid=7))
    return trace.from_events(events)


def test_a_graph_replay_reads_the_share_of_its_eager_calls():
    step = [Entry("avg_max_pool", (tuple(X),), "float32"),
            Entry("spatial_gate", (tuple(X), (1, 2, 7, 7)), "float32")]
    bound = 2 * roofline.schedule_bound_s(step, 1980)
    eager, graph = six_op_trace(graph=False), six_op_trace(graph=True)
    linked = roofline.roofline_share(trace.op_calls(eager, PREFIX), 1980)
    assert linked is not None
    # the program's kernels by name: 2 x (8 + 12) us, the conv left out
    assert trace.kernel_s(eager) == pytest.approx(40e-6)
    assert trace.kernel_s(graph) == pytest.approx(40e-6)
    assert roofline.share(bound, trace.kernel_s(eager)) == pytest.approx(
        linked)
    assert roofline.share(bound, trace.kernel_s(graph)) == pytest.approx(
        linked)
    # the link through op calls finds nothing in the replay
    assert roofline.roofline_share(trace.op_calls(graph, PREFIX), 1980) is None
    assert roofline.share(bound, 0.0) is None


@pytest.mark.parametrize("name, function", [
    (GATE, "gate_kernel"),
    ("void (anonymous namespace)::position_attention_kernel<__nv_bfloat16, "
     "8, 64, 1, 4, ((anonymous namespace)::Mode)2>(__nv_bfloat16 const*)",
     "position_attention_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "(anonymous namespace)::launch_clamp_scalar()>(int)",
     "vectorized_elementwise_kernel"),
    ("sm90_xmma_fprop_implicit_gemm", "sm90_xmma_fprop_implicit_gemm"),
])
def test_a_kernel_event_names_its_function(name, function):
    assert trace.kernel_function(name) == function


def test_bounds_of_the_attention():
    # K3 at the train step's shape: 2 B N^2 (8 + 64) products in bf16 and
    # B N^2 exponentials; the larger term bounds it
    dims = [[16, 2916, 8], [16, 2916, 8], [16, 2916, 64], []]
    c = roofline.counts("position_attention", dims, 2)
    assert c["flops"] == 2 * 16 * 2916 ** 2 * 72
    assert c["exps"] == 16 * 2916 ** 2
    rate = roofline.exps_rate(1980)
    b = roofline.bound_s("position_attention", dims, "bfloat16", rate)
    assert b == pytest.approx(max(c["exps"] / rate,
                                  c["flops"] / roofline.PEAK_FLOPS["bfloat16"]))
