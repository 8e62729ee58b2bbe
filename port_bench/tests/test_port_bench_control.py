"""The control at a size a test run holds: the reference with its
products' operands rounded to float8 (the precision below the training
configurations' bf16), or run with TF32 on (below serving's float32 with
TF32 off), put in the program's place, must fail the cell's limits, where
the program's own readings pass them; so must the reference with half of
each batch or with no gradient through the position attention's queries,
and the G's gradient negated must move the later steps' losses."""

import json
from pathlib import Path

import pytest
import torch

from port_bench import calibrate, harness, serve, train
from port_bench.reference.models import (EXACT, Linear, Numerics, Products,
                                         set_numerics)
from port_bench.tests.tiny import float32_copy

BENCH = Path(__file__).resolve().parents[1]


def limits(cell):
    return json.loads((BENCH / "limits" / f"{cell}.json").read_text())


# at the tiny SRADSGAN the query conv's gradient is under the rounding
# rule's share of the median leaf, so no_dq leaves nothing read unmoved
@pytest.mark.parametrize("cell,failing", [
    ("sradsgan_x4.train_b16", ("control", "half_batch")),
    ("sragan_x4.train_b16", ("control", "half_batch", "no_dq"))])
def test_train_control_fails_where_the_program_passes(tmp_path, cell,
                                                      failing):
    manifest = float32_copy(tmp_path)
    c = harness.load_cell(cell, manifest)
    measured = train.run(c, 2_147_483_659, 0.0, False, "cpu", str(tmp_path))
    assert harness.passed(harness.check(measured["readings"], limits(cell)))
    upper = calibrate.train_upper(c, measured, "cpu")
    for name in failing:
        assert not harness.passed(harness.check(upper[name], limits(cell))), (
            name, upper[name])
    # the G stepping uphill: at this size its later losses move by less
    # than the full size's limit, by far more than rounding
    assert upper["g_sign"]["loss_gap"] > 1e3 * measured["readings"]["loss_gap"]


def test_fp8_numerics_round_to_float8():
    x = torch.tensor([1.0, 1.06, 300.0, -0.001])
    q = Numerics(fp8=True)(x)
    assert torch.equal(q, (x / (300 / 448)).to(torch.float8_e4m3fn).float()
                       * (300 / 448))
    assert not torch.equal(q, x)


def test_linear_and_products_take_the_models_numerics():
    """Bitwise plain under exact numerics, rounded to float8 once
    ``set_numerics`` gives the control's."""
    g = torch.Generator().manual_seed(3)
    x, a, b = (torch.randn(*s, generator=g) for s in ((4, 6), (2, 5, 6),
                                                      (2, 6, 3)))
    net = torch.nn.Sequential(Linear(6, 3), Products())
    with torch.no_grad():
        net[0].weight.copy_(torch.randn(3, 6, generator=g))
        net[0].bias.copy_(torch.randn(3, generator=g))
    lin, prod = net
    plain = (torch.nn.functional.linear(x, lin.weight, lin.bias), a @ b,
             torch.einsum("bij,bjk->bik", a, b))

    def outputs():
        return (lin(x), prod.matmul(a, b), prod.einsum("bij,bjk->bik", a, b))
    assert lin.numerics is EXACT and prod.numerics is EXACT
    for got, want in zip(outputs(), plain):
        assert torch.equal(got, want)
    set_numerics(net, Numerics(fp8=True))
    for got, want in zip(outputs(), plain):
        assert not torch.equal(got, want)
        assert torch.allclose(got, want, rtol=0.2, atol=0.2)
    n = Numerics(fp8=True)
    assert torch.equal(prod.matmul(a, b), n(a) @ n(b))


@pytest.mark.gpu
def test_serve_control_fails_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on the card only")
    cell = harness.load_cell("sradsgan_x4.serve_ucm",
                             BENCH.parent / "BENCHMARK.json")
    measured = serve.run(cell, 2_147_483_659, 4.0, False, "cuda:0",
                         str(tmp_path))
    lim = limits("sradsgan_x4.serve_ucm")
    assert harness.passed(harness.check(measured["readings"], lim))
    upper = calibrate.serve_upper(cell, measured, "cuda:0")
    assert not harness.passed(harness.check(upper["control"], lim))
