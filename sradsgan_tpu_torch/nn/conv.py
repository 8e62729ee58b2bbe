"""A 2-D convolution whose second-order weight term runs as a weight gradient.

The WGAN-GP penalty takes the D's input gradient with ``create_graph=True``,
and the D's update differentiates that gradient once more.  For each conv
the new term is d(input gradient)/dW contracted with the incoming ``ggI``.
PyTorch's conv double backward (ATen's ``_convolution_double_backward``)
computes it as a forward convolution of ``ggI`` transposed to
(C_in, B, H, W) with ``gO`` transposed to (C_out, B, H', W') as its filter:
a filter as large as the feature map, which no modern cuDNN engine takes, so
cuDNN runs it on its legacy implicit-GEMM engines.  The same sum is the
weight gradient of the conv at input ``ggI`` and output gradient ``gO``.
:class:`DoubleGradConv2d` takes it so, on cuDNN's backward-filter engines:
the same operands, the same precision, and the same result but for the order
of summation.

The first-order backward launches what stock autograd launches: the input
gradient (dgrad) and the weight gradient (wgrad) as separate cuDNN calls,
each only where the backward pass running needs it, and the bias gradient
as ``gO.sum((0, 2, 3))``.  ``_InputGrad.weight_terms`` counts the
second-order weight terms taken (nine a WGAN-GP step of the patch D, eager
or captured; a CUDA graph's replay runs no Python and counts none).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd import Function

_conv_backward = torch.ops.aten.convolution_backward.default
_DILATION, _OUTPUT_PADDING = (1, 1), (0, 0)


def _wanted(ctx, i: int) -> bool:
    """Whether the backward pass running now needs the gradient of input
    ``i`` of ``ctx``'s Function.  Autograd's own formulas skip a gradient
    that the inputs of ``torch.autograd.grad`` do not reach (the penalty's
    pass takes no weight gradient), and so does this."""
    if not ctx.needs_input_grad[i]:
        return False
    try:
        return torch._C._will_engine_execute_node(ctx.next_functions[i][0])
    except RuntimeError:  # a leaf that torch.autograd.grad returns
        return True


def _dgrad(g_out: torch.Tensor, weight: torch.Tensor, like: torch.Tensor,
           stride, padding) -> torch.Tensor:
    """The input gradient of ``conv(x, weight)`` at output gradient
    ``g_out``, for an ``x`` of ``like``'s shape (stride 2 maps 27 and 28
    alike to 14)."""
    return _conv_backward(g_out, like, weight, None, stride, padding,
                          _DILATION, False, _OUTPUT_PADDING, 1,
                          (True, False, False))[0]


def _wgrad(g_out: torch.Tensor, x: torch.Tensor, like: torch.Tensor,
           stride, padding) -> torch.Tensor:
    """The weight gradient of ``conv(x, w)`` at output gradient ``g_out``,
    for a ``w`` of ``like``'s shape."""
    return _conv_backward(g_out, x, like, None, stride, padding, _DILATION,
                          False, _OUTPUT_PADDING, 1, (False, True, False))[1]


class _InputGrad(Function):
    """``_dgrad(g_out, weight)``, differentiable: d/d``g_out`` is the conv
    of ``ggI`` with ``weight``; d/d``weight`` is the weight gradient at
    input ``ggI`` and output gradient ``g_out``."""

    weight_terms = 0  # second-order weight terms taken

    @staticmethod
    def forward(ctx, g_out, weight, like, stride, padding):
        ctx.save_for_backward(g_out, weight)
        ctx.conv = stride, padding
        return _dgrad(g_out, weight, like, stride, padding)

    @staticmethod
    def backward(ctx, gg_in):
        g_out, weight = ctx.saved_tensors
        stride, padding = ctx.conv
        gg_out = g_weight = None
        if _wanted(ctx, 0):
            gg_out = F.conv2d(gg_in, weight, None, stride, padding)
        if _wanted(ctx, 1):
            _InputGrad.weight_terms += 1
            g_weight = _wgrad(g_out, gg_in, weight, stride, padding)
        return gg_out, g_weight, None, None, None


class _WeightGrad(Function):
    """``_wgrad(g_out, x)``, differentiable: d/d``g_out`` is the conv of
    ``x`` with ``ggW``; d/d``x`` is the input gradient at output gradient
    ``g_out`` and weight ``ggW``."""

    @staticmethod
    def forward(ctx, g_out, x, like, stride, padding):
        ctx.save_for_backward(g_out, x)
        ctx.conv = stride, padding
        return _wgrad(g_out, x, like, stride, padding)

    @staticmethod
    def backward(ctx, gg_weight):
        g_out, x = ctx.saved_tensors
        stride, padding = ctx.conv
        gg_out = g_x = None
        if _wanted(ctx, 0):
            gg_out = F.conv2d(x, gg_weight, None, stride, padding)
        if _wanted(ctx, 1):
            g_x = _dgrad(g_out, gg_weight, x, stride, padding)
        return gg_out, g_x, None, None, None


class _Conv(Function):
    """``F.conv2d(x, weight, bias)`` whose input and weight gradients are
    :class:`_InputGrad` and :class:`_WeightGrad`."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conv = stride, padding
        return F.conv2d(x, weight, bias, stride, padding)

    @staticmethod
    def backward(ctx, g_out):
        x, weight = ctx.saved_tensors
        stride, padding = ctx.conv
        g_x = g_weight = g_bias = None
        if _wanted(ctx, 0):
            g_x = _InputGrad.apply(g_out, weight, x.detach(), stride,
                                   padding)
        if _wanted(ctx, 1):
            g_weight = _WeightGrad.apply(g_out, x, weight.detach(), stride,
                                         padding)
        if _wanted(ctx, 2):
            g_bias = g_out.sum((0, 2, 3))
        return g_x, g_weight, g_bias, None, None


def _autocast(t: Optional[torch.Tensor],
              dtype: torch.dtype) -> Optional[torch.Tensor]:
    """``t`` as autocast casts a conv's argument: a floating tensor other
    than float64 to ``dtype``."""
    if t is None or not t.is_floating_point() or t.dtype == torch.float64:
        return t
    return t.to(dtype)


class DoubleGradConv2d(nn.Conv2d):
    """``nn.Conv2d`` (zero padding, dilation 1, one group) whose gradient,
    differentiated once more, takes its weight term on the weight-gradient
    engines (see the module's docstring).  Parameters, their names and
    their init are ``nn.Conv2d``'s; under autocast the input, weight and
    bias are cast to autocast's dtype, as autocast casts a conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=bias)
        if isinstance(self.padding, str):
            raise ValueError("DoubleGradConv2d takes numeric padding")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        args = x, self.weight, self.bias
        device = x.device.type
        if torch.is_autocast_enabled(device):
            dtype = torch.get_autocast_dtype(device)
            args = tuple(_autocast(t, dtype) for t in args)
        return _Conv.apply(*args, self.stride, self.padding)
