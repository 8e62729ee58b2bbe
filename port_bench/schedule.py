"""The work of one unit in the six functions the program's kernels
implement, read off the plain reference.

A unit is one train step or one request.  Its schedule lists every call
of the six functions (``roofline.OPS``) that the configuration's step or
request needs: the function, its tensor inputs' dims as the program's
registered op takes them, their dtype, and for ``position_attention``
whether it also writes the row log-sum-exp (for its backward).  It is
recorded by hooks on the reference's modules, so it is the configuration's
work at the cell's shapes and precision, whatever launches it:

- each ``ChannelGate`` (CLAM) pools its input: ``avg_max_pool``;
- each ``SpatialGate`` (SLAM) gates its input: ``spatial_gate``; each
  time a backward pass reaches its output, ``spatial_gate_bwd`` (the
  first-order gradient, also inside the penalty's grad of grad; its own
  gradient is plain arithmetic, not a kernel's function);
- each ``SpatialSelfAttention`` (SGAM) attends over its positions with the
  dtype of its projections: ``position_attention``, with the log-sum-exp
  where a gradient will follow; each time a backward pass reaches its
  output, ``position_attention_bwd``.

The CA-SA tails are the unfused formulation, the program's default, which
both configurations state; a fused tail (``rab_tail``) is no unit's work.
A configuration whose reference holds none of these modules has an empty
schedule, and the kernel-roofline readers read nothing in its cells.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from port_bench.harness import build_reference, reference_path
from port_bench.reference.models import (ChannelGate, SpatialGate,
                                         SpatialSelfAttention)

GATE_WEIGHT = (1, 2, 7, 7)  # the SLAM's 7x7 conv over (mean, max)


class Entry(NamedTuple):
    """One call: ``dims`` the tensor inputs' shapes in the op's order,
    ``dtype`` "float32" or "bfloat16"."""

    op: str
    dims: Tuple[Tuple[int, ...], ...]
    dtype: str
    with_lse: bool = False


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _backward_each_time(out: torch.Tensor, entries: List[Entry],
                        entry: Entry) -> None:
    """Record ``entry`` whenever a backward pass computes ``out``'s
    gradient."""
    if out.requires_grad:
        out.register_hook(lambda g: entries.append(entry))


def _gate(entries: List[Entry]):
    def hook(module, inputs, out):
        x = inputs[0]
        dims, dtype = tuple(x.shape), dtype_name(x.dtype)
        entries.append(Entry("spatial_gate", (dims, GATE_WEIGHT), dtype))
        _backward_each_time(out, entries, Entry(
            "spatial_gate_bwd", (dims, GATE_WEIGHT, dims), dtype))
    return hook


def _pool(entries: List[Entry]):
    def hook(module, inputs):
        x = inputs[0]
        entries.append(Entry("avg_max_pool", (tuple(x.shape),),
                             dtype_name(x.dtype)))
    return hook


def _attention(entries: List[Entry], module: SpatialSelfAttention) -> List:
    """Hooks on an SGAM: its projections' dtype, which the attention takes
    its inputs in, and its call."""
    projected = {}

    def projection(conv, inputs, out):
        projected["dtype"] = dtype_name(out.dtype)

    def attention(module, inputs, out):
        b, c, h, w = inputs[0].shape
        qk, v = (b, h * w, module.query_conv.out_channels), (b, h * w, c)
        dtype = projected["dtype"]
        entries.append(Entry("position_attention", (qk, qk, v), dtype,
                             out.requires_grad))
        _backward_each_time(out, entries, Entry(
            "position_attention_bwd", (qk, qk, v, v, v, (b, h * w)), dtype))
    return [module.query_conv.register_forward_hook(projection),
            module.register_forward_hook(attention)]


@contextlib.contextmanager
def recording(*nets: nn.Module) -> Iterator[List[Entry]]:
    """Hooks on every CLAM, SLAM and SGAM of ``nets``; yields the list the
    calls are appended to, in the order they are made."""
    entries: List[Entry] = []
    handles = []
    for net in nets:
        for m in net.modules():
            if isinstance(m, ChannelGate):
                handles.append(m.register_forward_pre_hook(_pool(entries)))
            elif isinstance(m, SpatialGate):
                handles.append(m.register_forward_hook(_gate(entries)))
            elif isinstance(m, SpatialSelfAttention):
                handles += _attention(entries, m)
    try:
        yield entries
    finally:
        for h in handles:
            h.remove()


@functools.lru_cache(maxsize=None)
def _request(reference: Optional[str], model: str, widths: Tuple,
             batch: int, size: int) -> Tuple[Entry, ...]:
    g = build_reference(reference, model, "meta", dict(widths)).eval()
    with recording(g) as entries, torch.no_grad():
        g(torch.empty(batch, 3, size, size, device="meta"))
    return tuple(entries)


def request(config, batch: int, size: int) -> Tuple[Entry, ...]:
    """The calls of one request of ``batch`` images padded to ``size``
    square, in float32 (the serving precision): the reference generator's
    forward on the meta device."""
    return _request(reference_path(config), config["model"],
                    tuple(sorted(config["widths"].items())), batch, size)
