"""A configuration's own plain reference, found by the path it names, and
its recipe: what the harness builds, counts and reads for each."""

import json

import pytest
import torch

from port_bench import compare, flops, harness, schedule
from port_bench.reference.step import ReferenceStep
from port_bench.tests.tiny import tiny_copy, tiny_widths
from port_bench.weights import make_weights

MODULE = '''"""A plain generator for the tests: {n} 3x3 convs of {{width}}
channels, then x4 nearest upsampling."""

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.models import Conv

TINY_WIDTHS = {{"width": 5}}


class Net(nn.Module):
    def __init__(self, width=64):
        super().__init__()
        self.body = nn.Sequential(Conv(3, width, 3, padding=1),
                                  *(Conv(width, width, 3, padding=1)
                                    for _ in range({n} - 2)),
                                  Conv(width, 3, 3, padding=1))

    def forward(self, x):
        return F.interpolate(self.body(x), scale_factor=4)


def build(device, **widths):
    with torch.device("meta"):
        model = Net(**widths)
    return model.to_empty(device=device)
'''
PIXEL_RECIPE = {"gan": "none", "pixel": "l1", "lr": 1e-3,
                "betas": [0.9, 0.99], "eps": 1e-8}


def with_reference(tmp_path, n_convs=3):
    """A tiny copy with a configuration "net" that names its own reference
    module, and its cell "net.serve_ucm"; returns the copy's manifest."""
    tmp_path.mkdir(exist_ok=True)
    manifest = tiny_copy(tmp_path)
    bench = tmp_path / "port_bench"
    (bench / "reference" / f"net{n_convs}.py").write_text(
        MODULE.format(n=n_convs))
    cfg = {"name": "net", "source": "test", "model": "edsr", "scale": 4,
           "widths": {"width": 7}, "reference": f"reference/net{n_convs}.py",
           "recipe": PIXEL_RECIPE,
           "precision": {"train_bf16": False, "serve_dtype": "float32"}}
    (bench / "configs" / "net.json").write_text(json.dumps(cfg))
    m = json.loads(manifest.read_text())
    m["configs"].append({"name": "net", "source": "test", "reduced": [],
                         "file": "port_bench/configs/net.json", "why": "t"})
    m["workloads"].append({"name": "net.serve_ucm", "config": "net",
                           "traffic": "ucm_test", "chips": 1, "why": "t"})
    manifest.write_text(json.dumps(m))
    (bench / "limits" / "net.serve_ucm.json").write_text('{"output_gap": 0}')
    return manifest


def test_a_configurations_reference_loads_by_path(tmp_path):
    manifest = with_reference(tmp_path)
    cell = harness.load_cell("net.serve_ucm", manifest)
    path = harness.reference_path(cell.config)
    assert path == str(tmp_path / "port_bench" / "reference" / "net3.py")
    g = harness.build_generator(cell.config, "cpu")
    assert [tuple(p.shape) for p in g.parameters()][::2] == [
        (7, 3, 3, 3), (7, 7, 3, 3), (3, 7, 3, 3)]
    assert harness.reference_module(path).TINY_WIDTHS == {"width": 5}
    assert tiny_widths(cell.config, tmp_path / "port_bench") == {"width": 5}
    # the built-in generators keep reference/models.py and the tiny table
    flagship = harness.load_cell("sradsgan_x4.serve_ucm", manifest).config
    assert harness.reference_path(flagship) is None
    assert tiny_widths(flagship, tmp_path / "port_bench") == {
        "base_filters": 16, "n_groups": 1, "n_blocks": 1}


def test_counts_are_keyed_by_the_reference_file(tmp_path):
    """Two references of one model name at the same widths count apart."""
    three = harness.load_cell("net.serve_ucm",
                              with_reference(tmp_path / "a", 3)).config
    four = harness.load_cell("net.serve_ucm",
                             with_reference(tmp_path / "b", 4)).config
    f3, f4 = (flops.forward_flops(c, 2, 8, 8) for c in (three, four))
    conv = 2 * 2 * 8 * 8 * 7 * 7 * 9
    assert f4 - f3 == conv
    # neither holds a CLAM, SLAM or SGAM: no call of the six functions
    assert schedule.request(three, 2, 8) == ()


def test_a_pixel_only_step_touches_only_g(tmp_path):
    cfg = harness.load_cell("net.serve_ucm", with_reference(tmp_path)).config
    assert not harness.adversarial(cfg)
    g = harness.build_generator(cfg, "cpu")
    weights = {"g": make_weights(g, 5, "generator")}
    ref = ReferenceStep(cfg, weights, "cpu")
    assert set(ref.nets()) == {"g"} and ref.vgg is None
    gen = torch.Generator().manual_seed(1)
    lr, hr = torch.rand(2, 3, 6, 6, generator=gen), torch.rand(
        2, 3, 24, 24, generator=gen)
    out = ref.step(lr, hr, None)
    g.load_state_dict(weights["g"])
    with torch.no_grad():
        sr = g(lr)
    assert set(out["losses"]) == set(compare.PIXEL_LOSS_KEYS)
    assert out["losses"]["pixel"] == pytest.approx(
        float((sr - hr).abs().mean()), rel=1e-6)
    assert set(out["grads"]) == {"g"}
    # forward and backward of G, the first conv's input gradient not taken
    forward = flops.forward_flops(cfg, 4, 6, 6)
    assert 2 * forward < flops.train_step_flops(cfg, 4, 6) < 3 * forward


def readings(nets, past_cgam=None):
    grads = {net: {f"{net}{i}": 1.0 + i for i in range(4)} for net in nets}
    losses = [{k: 1.0 for k in compare.LOSS_KEYS}] * 3
    program = {"losses": losses, "grad_norms": grads,
               "change1_norms": grads, "change_norms": grads}
    config = {"recipe": {"gan": "wgan-gp" if "d" in nets else "none"}}
    if past_cgam:
        config["leaves_past_cgam"] = past_cgam
    return compare.train_readings(program, program, config)


def test_the_readings_are_the_recipes():
    pixel = readings(["g"])
    worst = {f"{k}{w}" for k in ("grad_gap_g", "change1_gap", "change_gap")
             for w in ("", "_worst")}
    assert set(pixel) == worst | {"loss_gap", "loss_gap_first",
                                  "loss_gap_g"}
    gan = readings(["g", "d"], ["g2"])
    assert set(gan) == set(pixel) | {"grad_gap_d", "grad_gap_d_worst",
                                     "grad_gap_past_cgam",
                                     "grad_gap_past_cgam_worst"}
    assert set(readings(["g"], ["g2"])) == set(pixel) | {
        "grad_gap_past_cgam", "grad_gap_past_cgam_worst"}
    assert compare.loss_keys({"recipe": {"gan": "wgan-gp"}}) == (
        compare.LOSS_KEYS)
    assert compare.loss_keys({"recipe": {}}) == compare.PIXEL_LOSS_KEYS


def test_an_unknown_recipe_is_refused():
    with pytest.raises(ValueError, match="lsgan"):
        harness.adversarial({"recipe": {"gan": "lsgan"}})
