"""The work of a step and of a request in the six kernel functions, as the
reference's schedule reads it, against what the program calls: on the
CPU at tiny widths, the registered ops' host calls in a profile of the
program's eager step and request, op for op, dims and dtype; and every
kernel the program's sources define is one the roofline counts."""

import re
from collections import Counter

import pytest

from port_bench import harness, roofline, schedule, serve, train, trace
from port_bench.tests.tiny import tiny_copy

PREFIX = "sradsgan_tpu_torch::"


def program_calls(tr) -> Counter:
    """The traced segment's registered-op calls by (op, tensor dims,
    dtype of the first input)."""
    return Counter((c["name"], tuple(tuple(d) for d in c["dims"] if d),
                    roofline.dtype_name(c["types"][0]))
                   for c in trace.op_calls(tr, PREFIX))


def scheduled(entries, times: int = 1) -> Counter:
    out = Counter()
    for e in entries:
        assert e.op in roofline.OPS
        out[(e.op, e.dims, e.dtype)] += times
    return out


@pytest.mark.parametrize("cell", ["sradsgan_x4.train_b16",
                                  "sragan_x4.train_b16"])
def test_a_steps_schedule_is_what_the_program_calls(cell, tmp_path):
    # the configuration's mixed precision: bf16 activations on the CPU too
    manifest = tiny_copy(tmp_path)
    c = harness.load_cell(cell, manifest)
    m = train.run(c, 2_147_483_659, 0.1, True, "cpu", str(tmp_path))
    calls = program_calls(m["trace"])
    assert calls == scheduled(m["schedule"], m["traced_steps"])
    # both networks' gates, the D's in the penalty's grad of grad too
    assert {op for op, _, _ in calls} == set(roofline.OPS) - {"rab_tail"}
    assert {dtype for _, _, dtype in calls} == {"bfloat16"}
    # the forward's attention keeps its log-sum-exp for the backward
    lse = [e.with_lse for e in m["schedule"]
           if e.op == "position_attention"]
    assert lse == [True]


def test_a_requests_schedule_is_what_the_program_calls(tmp_path):
    manifest = tiny_copy(tmp_path)
    c = harness.load_cell("sradsgan_x4.serve_ucm", manifest)
    m = serve.run(c, 2_147_483_659, 0.1, True, "cpu", str(tmp_path))
    want = Counter()
    for b, size in m["traced_shapes"]:
        entries = schedule.request(c.config, b, size)
        assert not any(e.with_lse for e in entries)
        want += scheduled(entries)
    assert len(set(m["traced_shapes"])) == 2  # both of the mix's shapes
    assert program_calls(m["trace"]) == want


def test_every_kernel_of_the_sources_is_counted():
    from sradsgan_tpu_torch.ops import _build

    found = set()
    for path in sorted(_build.CSRC_DIR.iterdir()):
        text = path.read_text()
        for m in re.finditer(r"__global__", text):
            # the kernel's name is the last word before the first "(" past
            # its launch bounds, if any
            tail = re.sub(r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)", "",
                          text[m.end():m.end() + 400])
            found.add(re.search(r"(\w+)\s*\(", tail).group(1))
    assert "gate_bwd_kernel" in found and "attention_delta_kernel" in found
    assert found <= trace.kernel_names()
