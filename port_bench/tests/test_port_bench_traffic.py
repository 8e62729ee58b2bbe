"""The generators: a seed gives the same inputs every time, and another
seed the same work in another order with other pixels."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from port_bench import traffic, weights
from port_bench.reference.models import build

MIX = {"kind": "serve", "blocks": 2, "buckets": [54, 72, 108, 216],
       "requests": [{"count": 5, "batch": 1, "height": 54, "width": 54},
                    {"count": 3, "batch": 4, "height": 54, "width": 40}]}
BENCH = Path(__file__).resolve().parents[1]
SEED = 3_000_000_019  # over 2**31: seeds need more than 32 signed bits


def shapes(deck):
    return Counter(r.lr.shape for r in deck)


def test_same_seed_same_requests():
    a, b = traffic.request_deck(MIX, SEED), traffic.request_deck(MIX, SEED)
    assert [r.lr.shape for r in a] == [r.lr.shape for r in b]
    assert all(np.array_equal(x.lr, y.lr) for x, y in zip(a, b))


def test_other_seed_same_work_other_order():
    a, b = traffic.request_deck(MIX, SEED), traffic.request_deck(MIX, 7)
    assert shapes(a) == shapes(b)
    assert [r.lr.shape for r in a] != [r.lr.shape for r in b]
    assert not np.array_equal(a[0].lr, b[0].lr) or a[0].lr.shape != b[0].lr.shape


def test_mix_proportions():
    assert Counter(traffic.block_shapes(MIX)) == {(1, 54, 54): 5,
                                                  (4, 54, 40): 3}
    deck = traffic.request_deck(MIX, SEED)
    assert shapes(deck) == {(1, 54, 54, 3): 10, (4, 54, 40, 3): 6}


def test_the_cells_mix_is_the_published_test_protocol():
    mix = json.loads((BENCH / "traffic" / "ucm_test.json").read_text())
    assert Counter(traffic.block_shapes(mix)) == {(8, 54, 54): 32}


def test_same_seed_same_batches():
    mix = {"images": 6, "lr_size": 8}
    a = traffic.training_set(mix, 4, SEED, "cpu")
    b = traffic.training_set(mix, 4, SEED, "cpu")
    c = traffic.training_set(mix, 4, SEED + 1, "cpu")
    for k in ("lr", "hr", "bc"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    assert not np.array_equal(a.hr, c.hr)
    assert a.lr.shape == (6, 8, 8, 3) and a.hr.shape == (6, 32, 32, 3)
    assert a.hr.min() >= 0 and a.hr.max() <= 1


def test_same_seed_same_weights():
    g = build("sradsgan", "cpu", base_filters=16, n_groups=1, n_blocks=1)
    a = weights.make_weights(g, SEED, "generator")
    b = weights.make_weights(g, SEED, "generator")
    c = weights.make_weights(g, SEED, "discriminator")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.0.weight"], c["conv1.0.weight"])
    lo, hi = weights.GAMMA_RANGE
    assert lo <= float(a["GAB_UP.sa.gamma"]) <= hi
    assert lo <= float(a["GAB_UP.ca.gamma"]) <= hi


def test_check_sample_holds_the_largest():
    deck = traffic.request_deck(MIX, SEED)
    finished = list(range(12))
    sample = traffic.check_sample(deck, finished, 8, SEED)
    largest = max(finished, key=lambda i: deck[i].lr_pixels)
    assert largest in sample and len(sample) == 8
    assert sample == traffic.check_sample(deck, finished, 8, SEED)
