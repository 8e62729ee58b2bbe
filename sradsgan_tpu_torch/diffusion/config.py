"""GDP-style JSON configs of the diffusion sub-package.

Counterpart of ``sradsgan_tpu/diffusion/config.py`` (the reference's
GDP_x0 ``core/logger.py:21-107``): JSON with ``//`` comments, 12 configs
for the train/test pairs 108/72/54/27/24 -> 216 (scales 2/3/4/8/9) and the
GF-2 x3 / Sentinel-2 x9 inference.  The port's copies of the JAX package's
files live in ``sradsgan_tpu_torch/diffusion/configs/`` (a test holds them
byte-equal).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")

# LR resolution -> scale (reference sr_mfe.py:38-47)
RESOLUTION_TO_SCALE = {108: 2, 72: 3, 54: 4, 27: 8, 24: 9}


def load_gdp_config(path_or_name: str) -> Dict[str, Any]:
    """A GDP config by path or bundled name (``//`` comments dropped)."""
    path = path_or_name
    if not os.path.exists(path):
        candidate = os.path.join(CONFIG_DIR, path_or_name)
        if not candidate.endswith(".json"):
            candidate += ".json"
        path = candidate
    with open(path) as f:
        text = "".join(line.split("//")[0] for line in f)
    return json.loads(text)


def trainer_kwargs_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """A GDP config dict -> ``DiffusionTrainer`` constructor arguments."""
    unet = cfg.get("model", {}).get("unet", {})
    beta = cfg.get("model", {}).get("beta_schedule", {}).get("train", {})
    l_res = cfg.get("datasets", {}).get("val", {}).get("l_resolution", 54)
    scale = cfg.get("scale") or RESOLUTION_TO_SCALE.get(l_res, 4)
    return {
        "scale": scale,
        "schedule": beta.get("schedule", "linear"),
        "n_timestep": beta.get("n_timestep", 1000),
        "linear_start": beta.get("linear_start", 1e-4),
        "linear_end": beta.get("linear_end", 2e-2),
        "lr": cfg.get("train", {}).get("optimizer", {}).get("lr", 1e-4),
        "unet_kwargs": {
            "in_channel": unet.get("in_channel", 6),
            "out_channel": unet.get("out_channel", 3),
            "inner_channel": unet.get("inner_channel", 64),
            "channel_mults": tuple(unet.get("channel_multiplier",
                                            (1, 2, 4, 8))),
            # the configs' pixel-size attn_res is dead in the reference (its
            # UNet body ignores it and attends at downsample rate 8); the
            # JAX package keeps that effective behaviour, and so does this
            "attn_res": (8,),
            "res_blocks": unet.get("res_blocks", 2),
            "dropout": unet.get("dropout", 0.0),
        },
    }
