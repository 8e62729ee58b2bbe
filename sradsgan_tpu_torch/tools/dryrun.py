"""The compile entry and the multi-device dry run of the port.

Counterpart of the JAX package's root ``__graft_entry__.py``:

- :func:`entry` gives ``(forward, example_args)``, the flagship SRADSGAN x4
  at its published width (seed 0) in eval mode and one 54^2 LR image of
  zeros, NCHW, on ``device``;
- :func:`dryrun_multichip` runs one full WGAN-GP step of the flagship (one
  group of one RAB, crop 16, batch two a rank) and one step of GDP
  diffusion's tiny UNet (inner 32, mults (1, 2), one res block, no
  attention, 8 timesteps, crop 16) over ``n`` ranks, one process each
  (``tools/dp_check.run_ranks``): NCCL over ``n`` cards, gloo for
  ``device="cpu"``.  It asserts finite losses and prints the JAX dry run's
  two lines.  Asking for more ranks than there are cards raises; the JAX
  dry run runs on a virtual CPU mesh instead, the port on the cards.

    python -m sradsgan_tpu_torch.tools.dryrun [--devices N] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
from typing import Any, Callable, Dict, Tuple

import torch

from sradsgan_tpu_torch.tools import require_cuda

LR_SIZE = 54
SCALE = 4
DRY_CROP = 16
DRY_UNET = {"inner_channel": 32, "channel_mults": [1, 2], "res_blocks": 1,
            "attn_res": []}
DRY_TIMESTEPS = 8
DEADLINE_S = 600.0


def entry(device: torch.device | str = "cuda"
          ) -> Tuple[Callable[..., torch.Tensor], Tuple[Any, ...]]:
    """``(forward, (model, x))``: ``forward(model, x)`` is the flagship's
    inference forward, ``model`` the full-width x4 SRADSGAN of seed 0 in
    eval mode and ``x`` a (1, 3, 54, 54) zero image, both on ``device``."""
    from sradsgan_tpu_torch.models import create_generator

    require_cuda(device, "entry")
    model = create_generator("sradsgan", SCALE, device=device).eval()
    x = torch.zeros((1, 3, LR_SIZE, LR_SIZE), device=device)

    def forward(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(x)

    return forward, (model, x)


def dry_spec(n_devices: int, device: torch.device | str,
             work_dir: str) -> Dict[str, Any]:
    """The ranks' spec of :func:`dryrun_multichip` (its config file written
    under ``work_dir``)."""
    from sradsgan_tpu_torch.config import save_config
    from sradsgan_tpu_torch.models import config_for_model

    batch = 2 * n_devices
    cfg = config_for_model(
        "sradsgan", SCALE, bf16=False, num_devices=n_devices,
        model_kwargs={"n_groups": 1, "n_blocks": 1},
        save_dir=os.path.join(work_dir, "run"))
    cfg.data.crop_size = DRY_CROP
    cfg.data.batch_size = batch
    config = os.path.join(work_dir, "dryrun_config.json")
    save_config(cfg, config)
    cuda = torch.device(device).type == "cuda"
    return {"device": "cuda" if cuda else "cpu",
            "backend": "nccl" if cuda else "gloo",
            "scenarios": [
                {"name": "gan", "kind": "gan", "config": config, "seed": 0,
                 "steps": 1, "batch": batch, "lr_size": DRY_CROP // SCALE,
                 "alpha_seed": 0},
                {"name": "diffusion", "kind": "diffusion", "scale": SCALE,
                 "crop": DRY_CROP, "batch": batch, "unet_kwargs": DRY_UNET,
                 "timesteps": DRY_TIMESTEPS, "seed": 1, "steps": 1,
                 "draw_seed": 1}]}


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda"
                     ) -> Dict[str, Any]:
    """One GAN step and one diffusion step over ``n_devices`` ranks;
    returns rank 0's losses.  Raises if a loss is not finite, if a rank
    fails, or, on the card, if fewer than ``n_devices`` cards are
    visible."""
    from sradsgan_tpu_torch.tools.dp_check import run_ranks

    require_cuda(device, "dryrun_multichip")
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if cards < n_devices:
            raise RuntimeError(f"dryrun_multichip: need {n_devices} CUDA "
                               f"devices, have {cards}")
    with tempfile.TemporaryDirectory() as work:
        ranks = run_ranks(dry_spec(n_devices, device, work), n_devices,
                          work, DEADLINE_S)
    for r, res in enumerate(ranks):
        values = (list(res["gan"]["losses"][0].values())
                  + res["diffusion"]["losses"])
        if not all(math.isfinite(v) for v in values):
            raise RuntimeError(f"dryrun_multichip: rank {r} losses are not "
                               f"finite: {res['gan']['losses']}, "
                               f"{res['diffusion']['losses']}")
    out = ranks[0]["gan"]["losses"][0]
    dloss = ranks[0]["diffusion"]["losses"][0]
    print(f"dryrun_multichip({n_devices}) ok:", out)
    print(f"dryrun_multichip({n_devices}) diffusion ok: loss={dloss:.4f}")
    return {"gan": out, "diffusion": dloss}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dryrun", description=__doc__.split(
        "\n\n")[0])
    p.add_argument("--device", default="cuda", help="'cuda' (default) or "
                   "'cpu' (gloo ranks)")
    p.add_argument("--devices", type=int, default=None,
                   help="ranks (default: every visible card; 2 on the CPU)")
    args = p.parse_args(argv)
    n = args.devices
    if n is None:
        n = (torch.cuda.device_count()
             if torch.device(args.device).type == "cuda" else 2)
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
