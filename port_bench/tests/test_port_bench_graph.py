"""On the card: the six ops' kernels replayed from a CUDA graph read the
roofline share and busy time of the same calls taken eagerly, which the
link through host op calls cannot see; and the kernel names the roofline
counts are the built library's kernels.

    python3 -m pytest port_bench/tests/test_port_bench_graph.py -m gpu
"""

import shutil
import subprocess

import pytest
import torch

from port_bench import roofline, trace
from port_bench.schedule import Entry

PREFIX = "sradsgan_tpu_torch::"
B, C, H, W = 16, 64, 54, 54        # the train step's RAB tails, bf16
N, DQK, HIDDEN = H * W, C // 8, C // 16


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs and the kernels exist on the card only")


def chain_and_schedule():
    """A chain of the six registered ops at the train step's shapes, and
    its schedule."""
    dev, bf = "cuda:0", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape, dtype=bf, scale=1.0):
        return (scale * torch.randn(*shape, device=dev, generator=g)
                ).to(dtype)
    x, dout = rnd(B, C, H, W), rnd(B, C, H, W)
    w = rnd(1, 2, 7, 7, dtype=torch.float32, scale=0.1)
    q, k, v = rnd(B, N, DQK), rnd(B, N, DQK), rnd(B, N, C)
    params = (rnd(C, HIDDEN, dtype=torch.float32, scale=0.1),
              rnd(HIDDEN, C, dtype=torch.float32, scale=0.1), w,
              rnd(C, C, dtype=torch.float32, scale=0.1),
              rnd(C, dtype=torch.float32, scale=0.1))
    ops = torch.ops.sradsgan_tpu_torch

    def chain():
        ops.avg_max_pool(x)
        ops.spatial_gate(x, w)
        ops.spatial_gate_bwd(x, w, dout)
        out, lse = ops.position_attention(q, k, v, True)
        ops.position_attention_bwd(q, k, v, out, v, lse)
        ops.rab_tail(x, dout, *params)
    img, gw, qk = (B, C, H, W), (1, 2, 7, 7), (B, N, DQK)
    step = [Entry("avg_max_pool", (img,), "bfloat16"),
            Entry("spatial_gate", (img, gw), "bfloat16"),
            Entry("spatial_gate_bwd", (img, gw, img), "bfloat16"),
            Entry("position_attention", (qk, qk, (B, N, C)), "bfloat16",
                  True),
            Entry("position_attention_bwd",
                  (qk, qk, (B, N, C), (B, N, C), (B, N, C), (B, N)),
                  "bfloat16"),
            Entry("rab_tail", (img, img, (C, HIDDEN), (HIDDEN, C), gw,
                               (C, C), (C,)), "bfloat16")]
    return chain, step


def traced(fn, times: int):
    def segment():
        for _ in range(times):
            fn()
        torch.cuda.synchronize()
    return trace.run_traced(segment)


@pytest.mark.gpu
def test_a_graph_replay_reads_the_eager_calls_share():
    needs_card()
    from sradsgan_tpu_torch.ops import register_all
    register_all()
    chain, step = chain_and_schedule()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain()
    graph.replay()
    torch.cuda.synchronize()

    times = 5
    eager, replay = traced(chain, times), traced(graph.replay, times)
    bound = times * roofline.schedule_bound_s(step, 1980)
    eager_share = roofline.share(bound, trace.kernel_s(eager))
    graph_share = roofline.share(bound, trace.kernel_s(replay))
    linked = roofline.roofline_share(trace.op_calls(eager, PREFIX), 1980)
    print(f"share eager {eager_share} graph {graph_share} linked {linked}; "
          f"busy eager {trace.busy_s(eager)} graph {trace.busy_s(replay)}")
    assert eager_share == pytest.approx(linked, rel=0.01)
    assert graph_share == pytest.approx(eager_share, rel=0.05)
    assert trace.busy_s(replay) == pytest.approx(trace.busy_s(eager),
                                                 rel=0.05)
    # the replay makes no op call, so the link finds nothing
    assert trace.op_calls(replay, PREFIX) == []
    assert roofline.roofline_share(trace.op_calls(replay, PREFIX),
                                   1980) is None


@pytest.mark.gpu
def test_the_sources_name_every_kernel_the_library_holds():
    needs_card()
    from torch.utils.cpp_extension import CUDA_HOME

    from sradsgan_tpu_torch.ops import _build
    dump = shutil.which("cuobjdump") or f"{CUDA_HOME}/bin/cuobjdump"
    if shutil.which(dump) is None or shutil.which("c++filt") is None:
        pytest.skip("needs the toolkit's cuobjdump and c++filt")
    _build.library()
    lib = _build.BUILD_DIR / _build.source_hash() / _build.LIB_NAME
    symbols = subprocess.run([dump, "-symbols", str(lib)], check=True,
                             capture_output=True, text=True).stdout
    entries = [line.split()[-1] for line in symbols.splitlines()
               if "STO_ENTRY" in line]
    names = subprocess.run(["c++filt"], input="\n".join(entries), check=True,
                           capture_output=True, text=True).stdout
    built = {trace.kernel_function(n) for n in names.splitlines()}
    assert built == set(trace.kernel_names())
