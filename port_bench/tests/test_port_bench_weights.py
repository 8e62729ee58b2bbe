"""The weights a run makes, by the kind of module that holds each leaf:
norm gains one and shifts zero, every other leaf's draw unmoved by the
norms beside it."""

import torch
from torch import nn

from port_bench.weights import make_weights

SEED = 2_147_483_659


class Net(nn.Module):
    def __init__(self, norms: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3)
        if norms:
            self.ln = nn.LayerNorm(8)
            self.gn = nn.GroupNorm(2, 8)
            self.bn = nn.BatchNorm2d(8)
        self.proj = nn.Linear(8, 8)
        self.conv2 = nn.Conv2d(8, 3, 1)


def test_norm_leaves_are_one_and_zero():
    w = make_weights(Net(norms=True), SEED, "generator")
    for norm in ("ln", "gn", "bn"):
        assert torch.equal(w[f"{norm}.weight"], torch.ones(8)), norm
        assert torch.equal(w[f"{norm}.bias"], torch.zeros(8)), norm
    assert torch.equal(w["bn.running_var"], torch.ones(8))
    assert torch.equal(w["bn.running_mean"], torch.zeros(8))
    assert int(w["bn.num_batches_tracked"]) == 0


def test_other_leaves_draw_as_without_the_norms():
    with_norms = make_weights(Net(norms=True), SEED, "generator")
    without = make_weights(Net(norms=False), SEED, "generator")
    for k, v in without.items():
        assert torch.equal(with_norms[k], v), k
    assert 0.01 < float(without["proj.weight"].std()) < 0.03
