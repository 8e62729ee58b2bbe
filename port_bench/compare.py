"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference works out from the same inputs."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Mapping, Sequence

import numpy as np

from port_bench.harness import adversarial

LOSS_KEYS = ("pixel", "content", "loss_G", "loss_D")  # WGAN-GP's
PIXEL_LOSS_KEYS = ("pixel", "loss_G")  # a pixel-only step's
# a leaf whose reference gradient norm is under this share of its
# network's median leaf moves under Adam by round-off alone
ROUNDING_LEAF = 1e-3


def loss_gap(program: Sequence[Mapping[str, float]],
             reference: Sequence[Mapping[str, float]],
             keys: Sequence[str] = LOSS_KEYS) -> float:
    """The widest relative gap of a step's loss over the steps given."""
    return max(abs(p[k] - r[k]) / abs(r[k])
               for p, r in zip(program, reference) for k in keys)


def loss_keys(config: Mapping) -> Sequence[str]:
    """The losses a step of the configuration's recipe yields."""
    return LOSS_KEYS if adversarial(config) else PIXEL_LOSS_KEYS


def kept_leaves(ref_grads: Mapping[str, Mapping[str, float]]
                ) -> Dict[str, List[str]]:
    """By network, the leaves whose reference gradient norm is at least
    ROUNDING_LEAF of the network's median leaf."""
    out = {}
    for net, norms in ref_grads.items():
        m = statistics.median(norms.values())
        out[net] = [n for n, v in norms.items() if v >= ROUNDING_LEAF * m]
    return out


def leaf_gaps(program: Mapping[str, Mapping[str, float]],
              reference: Mapping[str, Mapping[str, float]],
              kept: Mapping[str, Iterable[str]]
              ) -> Dict[str, Dict[str, float]]:
    """By network and leaf, each kept leaf's gap of norms, |program -
    reference| over the larger of the leaf's reference norm and its
    network's median reference norm."""
    gaps = {}
    for net, names in kept.items():
        ref = reference[net]
        m = statistics.median(ref[n] for n in names)
        gaps[net] = {n: abs(program[net][n] - ref[n]) / max(ref[n], m)
                     for n in names}
    return gaps


def past_cgam(config: Mapping, names: Iterable[str]) -> List[str]:
    """The G's leaves whose gradient does not flow back through the channel
    attention's softmax (CGAM), by the configuration's name prefixes."""
    prefixes = tuple(config["leaves_past_cgam"])
    return [n for n in names if n.startswith(prefixes)]


def worst_leaves(program: Mapping, reference: Mapping, config: Mapping,
                 n: int = 3) -> Dict[str, List]:
    """For the look behind a reading: the ``n`` leaves with the widest gaps
    of gradient and of change norms, as (gap, network, leaf), and of the
    G's gradient past CGAM where the configuration names those leaves."""
    kept = kept_leaves(reference["grad_norms"])

    def worst(key, nets):
        gaps = leaf_gaps(program[key], reference[key], nets)
        return sorted(((g, net, leaf) for net, gs in gaps.items()
                       for leaf, g in gs.items()), reverse=True)[:n]
    out = {key: worst(key, kept)
           for key in ("grad_norms", "change1_norms", "change_norms")}
    if "leaves_past_cgam" in config:
        out["grad_norms_past_cgam"] = worst(
            "grad_norms", {"g": past_cgam(config, kept["g"])})
    return out


def train_readings(program: Mapping, reference: Mapping,
                   config: Mapping) -> Dict[str, float]:
    """The readings of a training cell's check, of which its limits name
    the compared ones (PERF.md, section 2, says which and why):

    - ``loss_gap``: every checked step's losses (``loss_keys``: WGAN-GP's
      four, a pixel-only step's ``pixel`` and ``loss_G``);
      ``loss_gap_first``: the first step's; ``loss_gap_g``: the G's losses
      of the steps after the first, which follow the G's updates;
    - ``grad_gap_g``, and ``grad_gap_d`` where there is a D: the median
      leaf's gap of the first step's gradient norms in the G and in the D;
      ``grad_gap_past_cgam``, where the configuration names
      ``leaves_past_cgam``: of the G's leaves past CGAM; ``_worst``: the
      worst leaf's;
    - ``change1_gap``, ``change_gap``: the G's median leaf's gap of the
      parameters' change after the first step and after the last;
      ``_worst``: the worst leaf's.

    The D's change (the clip sets it) is not read."""
    kept = kept_leaves(reference["grad_norms"])
    pl, rl = program["losses"], reference["losses"]
    keys = loss_keys(config)
    out = {"loss_gap": loss_gap(pl, rl, keys),
           "loss_gap_first": loss_gap(pl[:1], rl[:1], keys),
           "loss_gap_g": loss_gap(pl[1:], rl[1:],
                                  [k for k in keys if k != "loss_D"])}
    grads = leaf_gaps(program["grad_norms"], reference["grad_norms"], kept)
    for net in sorted(grads):  # "d" where there is one, "g"
        out[f"grad_gap_{net}"] = statistics.median(grads[net].values())
        out[f"grad_gap_{net}_worst"] = max(grads[net].values())
    if "leaves_past_cgam" in config:
        tail = leaf_gaps(program["grad_norms"], reference["grad_norms"],
                         {"g": past_cgam(config, kept["g"])})["g"]
        out["grad_gap_past_cgam"] = statistics.median(tail.values())
        out["grad_gap_past_cgam_worst"] = max(tail.values())
    for name, key in (("change1_gap", "change1_norms"),
                      ("change_gap", "change_norms")):
        gaps = leaf_gaps(program[key], reference[key], {"g": kept["g"]})["g"]
        out[name] = statistics.median(gaps.values())
        out[f"{name}_worst"] = max(gaps.values())
    return out


def output_gap(program: Sequence[np.ndarray],
               reference: Sequence[np.ndarray]) -> float:
    """The widest gap of an output pixel, as a share of its request's
    largest reference value, over the compared requests; an output of
    another shape, or not finite, reads infinite."""
    def gap(p, r):
        if p.shape != r.shape or not np.isfinite(p).all():
            return float("inf")
        return float(np.abs(p - r).max() / np.abs(r).max())
    return max(gap(p, r) for p, r in zip(program, reference))
