"""Typed training configuration of the port.

The fields the port reads, with the defaults of the JAX package's
``TrainConfig`` (``sradsgan_tpu/core/config.py``); a test holds the two sets
of defaults equal.  Left out are two knobs of the TPU: ``steps_per_call``
(a ``lax.scan`` of the step) and ``data.device_degrade``.
``num_devices`` is the size of the data mesh (``parallel/mesh.py``): the
number of processes ``torchrun`` starts, -1 for whatever it started.
:func:`save_config` writes a config as JSON; :func:`load_config` reads that
and the JSON the JAX package's ``save_config`` writes, ignores those two
and refuses any other key it does not know.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class DataConfig:
    data_dir: str = "data"
    train_datasets: Tuple[str, ...] = ("AID", "DOTA", "LoveDA", "RSSCN7_2800",
                                       "SECOND")
    test_dataset: str = "UCMerced_LandUse"
    crop_size: int = 216          # HR crop (the reference trains on 216x216)
    test_crop_size: int = 216
    batch_size: int = 16
    test_batch_size: int = 1
    num_workers: int = 8
    synthetic: bool = False       # deterministic random data (tests, smoke)
    synthetic_size: int = 512     # images in the synthetic set
    max_train_samples: int = 100000


@dataclasses.dataclass
class OptimConfig:
    lr: float = 2e-4
    b1: float = 0.9
    b2: float = 0.999
    # Plateau backtracking: after `patience` epochs without improvement
    # reload the best checkpoint and halve the lr; training stops once the
    # lr is below lr_floor.
    plateau_patience: int = 5
    lr_floor: float = 1e-5
    # On a plateau also rewind the epoch counter to just after the best
    # epoch and pop `patience` entries of the metric histories.
    plateau_rewind: bool = True
    step_decay_epochs: int = 0    # halve the G lr every N epochs (0 = off)
    step_decay_gamma: float = 0.5


@dataclasses.dataclass
class GanConfig:
    gan_type: str = "wgan-gp"     # 'vanilla' | 'lsgan' | 'wgan-gp'
    relativistic: bool = False
    lambda_gp: float = 10.0
    # The reference backprops the penalty inside its gradient_penalty() and
    # again with loss_D, so the applied gradients carry (1 + lambda_gp).
    gp_inner_backward: bool = True
    clip_value: float = 0.01      # D weight clip after each D step
    weight_pixel: float = 1.0
    weight_content: float = 1e-2  # VGG19 perceptual
    weight_gan: float = 1e-3


@dataclasses.dataclass
class TrainConfig:
    model: str = "sradsgan"
    scale: int = 4
    num_channels: int = 3
    num_epochs: int = 50
    start_epoch: int = 0
    save_epochs: int = 1
    sample_interval: int = 100
    # Batches of the epoch-end validation sweep that feeds the plateau
    # policy; None = the whole test set, as the reference sweeps it.
    val_max_batches: Optional[int] = None
    seed: int = 0
    save_dir: str = "Result"
    # Chain training: warm-start G and D from a checkpoint of another scale;
    # tensors whose shape differs (the upsample tail) keep their fresh init.
    init_from: Optional[str] = None
    bf16: bool = True             # bf16 generator (and VGG) convs
    d_bf16: bool = True           # bf16 discriminator convs, with bf16 on
    val_lpips: bool = False       # LPIPS in the validation sweep
    # Ranks of the data mesh (one process a device); -1: as launched.
    num_devices: int = -1
    # Extra generator constructor kwargs (e.g. smaller test networks, or
    # {"rab_tail": "fused"}).
    model_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    gan: GanConfig = dataclasses.field(default_factory=GanConfig)

    @property
    def model_dir(self) -> str:
        return os.path.join(self.save_dir,
                            f"{self.model.upper()}_x{self.scale}")


_NESTED = {"data": DataConfig, "optim": OptimConfig, "gan": GanConfig}
# Keys of the JAX package's config that the port has no use for.
_TPU_KEYS = {TrainConfig: {"steps_per_call"},
             DataConfig: {"device_degrade"}}


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(v) for v in obj]
    return obj


def save_config(cfg: TrainConfig, path: str) -> None:
    """Write ``cfg`` as JSON, as the JAX package's ``save_config`` does;
    :func:`load_config` (of either package) reads it back."""
    with open(path, "w") as f:
        json.dump(_to_dict(cfg), f, indent=2)


def load_config(path: str) -> TrainConfig:
    """A TrainConfig from JSON (``//`` comments tolerated).  The JAX
    package's TPU knobs are ignored; any other unknown key raises."""
    with open(path) as f:
        text = "".join(line.split("//")[0] for line in f)
    raw: Dict[str, Any] = json.loads(text)

    def build(cls, d):
        unknown = (set(d) - {f.name for f in dataclasses.fields(cls)}
                   - _TPU_KEYS.get(cls, set()))
        if unknown:
            raise ValueError(f"{path}: unknown {cls.__name__} keys "
                             f"{sorted(unknown)}")
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if f.name in _NESTED:
                v = build(_NESTED[f.name], v)
            elif f.name == "train_datasets":
                v = tuple(v)
            kwargs[f.name] = v
        return cls(**kwargs)

    return build(TrainConfig, raw)
