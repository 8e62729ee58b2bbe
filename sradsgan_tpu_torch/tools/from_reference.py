"""Read the reference's PyTorch checkpoints into the port, without JAX.

Counterpart of ``sradsgan_tpu/tools/import_reference.py``, which maps the
reference's ``generator_param*.pkl`` state dicts onto the JAX package's
param trees.  The port's modules carry the reference's names (``conv1.0``,
``res_groups.{g}.RG.{b}.ca.fc1``, the patch D's flat ``model.{i}``, HAT's
``layers.{i}.residual_group.blocks.{j}.attn``, ...) and its OIHW layout, so
a reference state dict is the port's state dict but for a few keys:

- every key the port's module holds must be there with its shape (these are
  the keys the JAX reader of that model reads), or :func:`reference_state_dict`
  raises;
- BatchNorm's ``num_batches_tracked``, which the JAX readers ignore, is
  dropped and set to 0, as the JAX bridge (``tools/from_jax.py``) sets it;
- HAT's index buffers, which the port holds as numpy tables
  (``models/hat.py``: ``rpi_sa``, ``rpi_oca``, ``sw_attn_mask``), are
  checked against those tables and dropped: a
  ``relative_position_index_SA`` must equal ``rpi_sa(window)``, a
  ``relative_position_index_OCA``
  ``rpi_oca(window, overlap_ratio)``, an ``attn_mask`` of nW windows the
  shifted-window mask of a square image of sqrt(nW) windows a side, or the
  function raises;
- any other key is dropped.

What was dropped is reported in one ``UserWarning``.  The ten networks are
the nine generators of the registry (``models.available_models()``) and
``"discriminator"``, the patch D (``PatchDiscriminator``; its ``blocks``,
``kernel_size`` and ``use_attention`` as keyword arguments).

    from sradsgan_tpu_torch.tools.from_reference import load_reference
    model = load_reference("sradsgan", "generator_param.pkl", scale=4)
"""

from __future__ import annotations

import pickle
import warnings
from typing import Any, Dict, List, Mapping

import numpy as np
import torch
from torch import nn

DISCRIMINATOR = "discriminator"
_HAT_BUFFERS = ("relative_position_index_SA", "relative_position_index_OCA",
                "attn_mask")


def load_reference_state(path: str) -> Dict[str, torch.Tensor]:
    """The state dict in a reference checkpoint (``torch.save`` of a state
    dict, or of an object with ``.state_dict()`` that loads without code),
    on the CPU.  A pickled whole module is refused: reading it would run
    the reference's code."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as err:
        raise ValueError(
            f"{path} does not load as a state dict of tensors (a pickled "
            "module needs the reference's code to read; save its "
            f"state_dict() instead): {err}") from None
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if not isinstance(obj, Mapping) or not all(
            isinstance(v, torch.Tensor) for v in obj.values()):
        raise ValueError(f"{path} holds a {type(obj).__name__}, not a state "
                         "dict of tensors")
    return dict(obj)


def _template(model: str, scale: int, kwargs: Dict[str, Any]) -> nn.Module:
    """The port's network of that name, built on the CPU."""
    from sradsgan_tpu_torch.models import create_generator
    from sradsgan_tpu_torch.models.discriminators import PatchDiscriminator

    if model == DISCRIMINATOR:
        return PatchDiscriminator(**kwargs)
    return create_generator(model, scale, **kwargs)


def _hat_tables(template: nn.Module) -> Dict[str, Any]:
    from sradsgan_tpu_torch.models.hat import OCAB

    ocab = next(m for m in template.modules() if isinstance(m, OCAB))
    return {"window": ocab.window, "overlap_ratio": ocab.overlap_ratio}


def _check_hat_buffer(key: str, value: torch.Tensor,
                      tables: Dict[str, Any]) -> None:
    """Raise unless the reference's buffer equals the port's table."""
    from sradsgan_tpu_torch.models.hat import rpi_oca, rpi_sa, sw_attn_mask

    win = tables["window"]
    leaf = key.rpartition(".")[2]
    if leaf == "relative_position_index_OCA":
        want = rpi_oca(win, tables["overlap_ratio"])
    elif leaf == "attn_mask":
        side = int(round(np.sqrt(value.shape[0]))) if value.ndim else 0
        if value.ndim != 3 or side * side != value.shape[0]:
            raise ValueError(f"HAT buffer {key} of shape {tuple(value.shape)}"
                             " is not the mask of a square image")
        want = sw_attn_mask(side * win, side * win, win, win // 2)
    else:
        want = rpi_sa(win)
    got = value.numpy()
    if got.shape != want.shape or not np.array_equal(got, want):
        raise ValueError(f"HAT buffer {key} differs from the port's table "
                         f"(window {win}, overlap {tables['overlap_ratio']})")


def reference_state_dict(model: str, state: Mapping[str, Any],
                         scale: int = 4,
                         **model_kwargs) -> Dict[str, torch.Tensor]:
    """The port's state dict of ``model`` (a generator's name, or
    ``"discriminator"``) built with ``scale`` and ``model_kwargs``, from a
    reference state dict: float32 copies on the CPU, ``num_batches_tracked``
    0.  Raises ``KeyError`` for a missing key and ``ValueError`` for a shape
    that differs or a HAT index buffer that does not match; warns with the
    keys it dropped."""
    model = model.lower()
    return _convert(model, _template(model, scale, model_kwargs), state)


def _convert(model: str, template: nn.Module,
             state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    want = template.state_dict()
    state = {k: torch.as_tensor(v) for k, v in state.items()}
    missing = [k for k in want
               if k not in state and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"the reference state dict lacks {len(missing)} "
                       f"key(s) of {model}: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    out: Dict[str, torch.Tensor] = {}
    for key, t in want.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros((), dtype=torch.int64)
            continue
        value = state[key]
        if value.shape != t.shape:
            raise ValueError(f"{key}: the reference has shape "
                             f"{tuple(value.shape)}, {model} wants "
                             f"{tuple(t.shape)}")
        out[key] = value.detach().to(torch.float32, copy=True)
    dropped: List[str] = [k for k in state if k not in want
                          or k.endswith("num_batches_tracked")]
    if model == "hat":
        tables = _hat_tables(template)
        for key in dropped:
            if key.rpartition(".")[2] in _HAT_BUFFERS:
                _check_hat_buffer(key, state[key], tables)
    if dropped:
        warnings.warn(f"reference_state_dict({model!r}): dropped "
                      f"{len(dropped)} key(s) the port does not hold: "
                      f"{dropped}", stacklevel=3)
    return out


def load_reference(model: str, path: str, scale: int = 4, *,
                   device: torch.device | str = "cpu",
                   **model_kwargs) -> nn.Module:
    """The port's ``model`` built with ``scale`` and ``model_kwargs``, with
    the weights of the reference checkpoint at ``path``, on ``device``, in
    eval mode."""
    model = model.lower()
    net = _template(model, scale, model_kwargs)
    net.load_state_dict(_convert(model, net, load_reference_state(path)))
    return net.to(device).eval()
