"""The two configurations at their published widths read what they read
before a configuration could bring its own reference and recipe: the
FLOPs of a step and of a request, the schedules of a step's and a
request's calls of the six kernel functions, and the weights made on the
CPU from a seed.

The pinned values were computed by this file's arithmetic on commit
4531847 (the last before that change), through the functions that
commit had: ``flops.train_step_flops``, ``flops.forward_flops``,
``schedule.request``, ``reference.step.wgan_gp`` under ``recording`` and
``weights.make_weights``.  No full-size tensor is made: the FLOPs and the
request's schedule on the meta device, the step's schedule on fake CPU
tensors (``FakeTensorMode``), so that bf16 autocast applies as on the
card."""

import hashlib
import json
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from port_bench import flops, schedule
from port_bench.harness import build_generator
from port_bench.reference.models import build
from port_bench.reference.step import wgan_gp
from port_bench.schedule import recording
from port_bench.weights import make_weights

BENCH = Path(__file__).resolve().parents[1]
SEED = 2_147_483_659
BATCH, LR_SIZE, REQUEST = 16, 54, 8  # train_b16's and ucm_test's shapes

PINNED = {
    "sradsgan_x4": {
        "train_step_flops": 5993138823040,
        "forward_flops_train": 1107001393152,
        "forward_flops_request": 553500696576,
        "request": "4991e0b6a1dfb23fd8a91f66508d08be"
                   "8df3e58273711faf8f9cfb835814f964",
        "request_counts": {"avg_max_pool": 48, "position_attention": 1,
                           "spatial_gate": 48},
        "step": "f433a0e6e693fb2e03b5e3dbd6bbf925"
                "0967dc2a33ce32016fc81944cf575ca3",
        "step_counts": {"avg_max_pool": 52, "position_attention": 1,
                        "position_attention_bwd": 1, "spatial_gate": 52,
                        "spatial_gate_bwd": 53},
        "weights": {"g": "0c634887b3f1d36c38201db182946a9b"
                         "b5c916783d53c26283d331805321c1e4",
                    "d": "b53275182d8b81f791733c438ef811a4"
                         "be8c79e872a4389df7d7d77bf7c8a097",
                    "vgg": "ef447ea0f5853367030db874972cfdaa"
                           "a63ff4453054608bc080d976b6bedddc"}},
    "sragan_x4": {
        "train_step_flops": 4283798218624,
        "forward_flops_train": 537155500032,
        "forward_flops_request": 268577750016,
        "request": "9c1502fc5f04691df43aa8686914d3f3"
                   "9c4e2d4c94b0ba03ea4bef98d235f9be",
        "request_counts": {"avg_max_pool": 72, "position_attention": 1,
                           "spatial_gate": 72},
        "step": "2a5723132ec2ea806c50e3c17bd2720e"
                "f4db2aa8f4dbccd6686c5c4effaa38a1",
        "step_counts": {"avg_max_pool": 76, "position_attention": 1,
                        "position_attention_bwd": 1, "spatial_gate": 76,
                        "spatial_gate_bwd": 77},
        "weights": {"g": "7bc0e90bc3bbfd0ea9dc07a299bd8b4c"
                         "5b6684cacfff40a308016edf8f9a1f6e",
                    "d": "b53275182d8b81f791733c438ef811a4"
                         "be8c79e872a4389df7d7d77bf7c8a097",
                    "vgg": "ef447ea0f5853367030db874972cfdaa"
                           "a63ff4453054608bc080d976b6bedddc"}},
}


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def digest(entries) -> str:
    return hashlib.sha256(repr(list(entries)).encode()).hexdigest()


def counts(entries):
    out = {}
    for e in entries:
        out[e.op] = out.get(e.op, 0) + 1
    return out


def weights_digest(state) -> str:
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_flops_schedules_and_weights_hold(name):
    cfg, pin = config(name), PINNED[name]
    assert flops.train_step_flops(cfg, BATCH, LR_SIZE) == pin[
        "train_step_flops"]
    assert flops.forward_flops(cfg, BATCH, LR_SIZE, LR_SIZE) == pin[
        "forward_flops_train"]
    assert flops.forward_flops(cfg, REQUEST, LR_SIZE, LR_SIZE) == pin[
        "forward_flops_request"]

    request = schedule.request(cfg, REQUEST, LR_SIZE)
    assert counts(request) == pin["request_counts"]
    assert digest(request) == pin["request"]

    g = build_generator(cfg, "cpu").train()
    d = build("discriminator", "cpu").train()
    vgg = build("vgg", "cpu").requires_grad_(False)
    scale = cfg["scale"]
    with FakeTensorMode(allow_non_fake_inputs=True):
        lr = torch.empty(BATCH, 3, LR_SIZE, LR_SIZE)
        hr = torch.empty(BATCH, 3, LR_SIZE * scale, LR_SIZE * scale)
        alpha = torch.empty(BATCH, 1, 1, 1)
        with recording(g, d) as step:
            wgan_gp(g, d, vgg, cfg["recipe"], lr, hr, alpha, True)
    assert counts(step) == pin["step_counts"]
    assert digest(step) == pin["step"]

    for key, net, stream, fan_in in ((("g", g, "generator", False),
                                      ("d", d, "discriminator", False),
                                      ("vgg", vgg, "vgg", True))):
        w = make_weights(net, SEED, stream, fan_in_std=fan_in)
        assert weights_digest(w) == pin["weights"][key], key
