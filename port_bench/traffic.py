"""The one generator of every traffic mix: a training set or a deck of
requests, made from ``--seed`` and a mix's parameters
(``traffic/<mix>.json``).

A seed changes the pixels and the order, never the work: every seed gets
the same sizes in the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.weights import sub_seed


class TripletSet:
    """An in-memory training set of (lr, hr, bc) NHWC float32 images in
    [0, 1], in the program's dataset interface (``len``, ``load``)."""

    def __init__(self, lr: np.ndarray, hr: np.ndarray, bc: np.ndarray):
        self.lr, self.hr, self.bc = lr, hr, bc

    def __len__(self) -> int:
        return len(self.lr)

    def load(self, index: int, rng=None) -> Dict:
        return {"lr": self.lr[index], "hr": self.hr[index],
                "bc": self.bc[index], "path": f"triplet_{index}"}


def training_set(mix: Mapping, scale: int, seed: int,
                 device) -> TripletSet:
    """``mix["images"]`` HR crops of ``lr_size * scale`` pixels: smooth
    random fields (bicubic from an eighth of the size) plus fine noise,
    drawn on ``device``; LR by antialiased bicubic downscaling, bc its
    bicubic upscale, as the reference's triplets are made."""
    n, lr_size = mix["images"], mix["lr_size"]
    hr_size = lr_size * scale
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "data"))
    coarse = torch.rand((n, 3, hr_size // 8, hr_size // 8), generator=gen,
                        device=device)
    fine = torch.rand((n, 3, hr_size, hr_size), generator=gen, device=device)
    hr = (0.85 * F.interpolate(coarse, size=hr_size, mode="bicubic",
                               align_corners=False)
          + 0.15 * fine).clamp(0, 1)
    lr = F.interpolate(hr, size=lr_size, mode="bicubic", antialias=True,
                       align_corners=False).clamp(0, 1)
    bc = F.interpolate(lr, size=hr_size, mode="bicubic",
                       align_corners=False).clamp(0, 1)

    def host(t):
        return t.permute(0, 2, 3, 1).contiguous().cpu().numpy()

    return TripletSet(host(lr), host(hr), host(bc))


@dataclasses.dataclass
class Request:
    """One request: ``lr`` (batch, h, w, 3) float32 in [0, 1]."""

    lr: np.ndarray

    @property
    def lr_pixels(self) -> int:
        k, h, w, _ = self.lr.shape
        return k * h * w


def block_shapes(mix: Mapping) -> List[tuple]:
    """The (batch, h, w) of one block of the deck: ``count`` requests of
    each entry of ``mix["requests"]``, in the mix's order."""
    return [(r["batch"], r["height"], r["width"])
            for r in mix["requests"] for _ in range(r["count"])]


def request_deck(mix: Mapping, seed: int) -> List[Request]:
    """``mix["blocks"]`` blocks of :func:`block_shapes`, each in an order
    and with pixels drawn from the seed."""
    rng = np.random.default_rng(sub_seed(seed, "requests"))
    shapes = block_shapes(mix)
    deck = []
    for _ in range(mix["blocks"]):
        for i in rng.permutation(len(shapes)):
            k, h, w = shapes[i]
            deck.append(Request(rng.random((k, h, w, 3), dtype=np.float32)))
    return deck


def check_sample(deck: List[Request], finished: List[int], size: int,
                 seed: int) -> List[int]:
    """Indices of the requests whose outputs the check compares: among the
    ``finished`` ones, the one with the most LR pixels, and the rest drawn
    from the seed."""
    if not finished:
        return []
    largest = max(finished, key=lambda i: deck[i].lr_pixels)
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    others = [finished[j] for j in rng.permutation(len(finished))
              if finished[j] != largest]
    return sorted([largest] + others[:size - 1])
