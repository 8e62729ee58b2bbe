"""Faults planted under the timed path, to see ``correct`` come out false
(``--plant <fault>``, which the tests pass; the benchmark's own runs
plant nothing).

- ``unchanged``: each train step returns the trainer's state as it found
  it;
- ``half_batch``: each train step takes the first half of its rows, the
  means over them alone;
- ``altered_answer``: one value of each served answer changed.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def unchanged(trainer, step: Callable) -> Callable:
    nets = [n for n in (trainer.generator, trainer.discriminator)
            if n is not None]

    def run(batch):
        saved = [{k: v.clone() for k, v in n.state_dict().items()}
                 for n in nets]
        out = step(batch)
        for n, s in zip(nets, saved):
            n.load_state_dict(s)
        return out
    return run


def half_batch(trainer, step: Callable) -> Callable:
    def run(batch):
        half = {k: v[:len(v) // 2] for k, v in batch.items()
                if isinstance(v, torch.Tensor)}
        return step(half)
    return run


def altered_answer(predictor: Callable) -> Callable:
    def run(lr01):
        out = predictor(lr01).copy()
        out.reshape(-1)[0] += 0.5
        return out
    return run


TRAIN = {"unchanged": unchanged, "half_batch": half_batch}
SERVE = {"altered_answer": altered_answer}


def hooks(name: str) -> Dict[str, Callable]:
    """The run's hooks for the fault ``name`` ("" plants none)."""
    if not name:
        return {}
    if name in TRAIN:
        return {"step": TRAIN[name]}
    return {"call": SERVE[name]}
