"""The plain reference of one train step, WGAN-GP or pixel-only by the
configuration's recipe, and of a served request.

The WGAN-GP step is the published recipe (``main_sradsgan.py:31-58``):
the G loss ``w_pixel * L1(sr, hr) + w_content * L1(VGG(sr), VGG(hr)) -
w_gan * mean(D(sr))`` (L1 the recipe's ``pixel`` loss) and one Adam step
on G; then the D loss ``-mean(D(hr)) + mean(D(sr))`` plus the gradient
penalty on random interpolates (the norm of D's input gradient over the
channels at each pixel, ``(norm - 1)^2`` averaged), whose gradient the
reference applies ``lambda + 1`` times while the logged loss carries
``lambda``; one Adam step on D, then every D parameter clipped to
``+-clip``.  BatchNorm layers run in train mode over the whole batch.  The
pixel-only step (``"gan": "none"``) is the configuration's pixel loss of
G's output, times ``weight_pixel`` (1 where the recipe names none), and
one Adam step on G.  Nothing of the program.  In the configuration's mixed
precision the forwards run under bf16 autocast (``models.py``), the losses
in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from port_bench.harness import adversarial, build_generator
from port_bench.reference.models import EXACT, Numerics, build, set_numerics
from port_bench.schedule import recording


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return (d * d).mean()


PIXEL_LOSSES = {"l1": l1, "l2": l2}


def pixel_only(g, recipe: Mapping, lr: torch.Tensor, hr: torch.Tensor,
               bf16: bool = False) -> Tuple[Dict, Tuple[List]]:
    """The step's losses and the gradients of G's parameters: the pixel
    loss of G's output, G's forward under bf16 autocast with ``bf16``, the
    loss in float32."""
    g_params = list(g.parameters())
    if bf16:
        with torch.autocast(lr.device.type, dtype=torch.bfloat16):
            sr = g(lr)
    else:
        sr = g(lr)
    pixel = PIXEL_LOSSES[recipe["pixel"]](sr.float(), hr)
    loss_g = recipe.get("weight_pixel", 1.0) * pixel
    return ({"pixel": pixel, "loss_G": loss_g},
            (list(torch.autograd.grad(loss_g, g_params)),))


def wgan_gp(g, d, vgg, recipe: Mapping, lr: torch.Tensor, hr: torch.Tensor,
            alpha: torch.Tensor, bf16: bool = False
            ) -> Tuple[Dict, Tuple[List, List]]:
    """The step's losses and the gradients of G's and D's parameters, both
    taken before either network is updated (the D step sees the G step's
    detached sr and the D that the G step saw).  ``bf16``: the forwards
    under bf16 autocast (the mixed precision); losses in float32."""
    r = recipe
    g_params, d_params = list(g.parameters()), list(d.parameters())

    def mixed(net):
        def run(x):
            with torch.autocast(x.device.type, dtype=torch.bfloat16):
                return net(x)
        return run if bf16 else net
    g, d, vgg = mixed(g), mixed(d), mixed(vgg)
    loss = PIXEL_LOSSES[r["pixel"]]
    sr = g(lr)
    pixel = loss(sr.float(), hr)
    f_sr, f_hr = vgg(torch.cat([sr.float(), hr])).float().chunk(2)
    content = loss(f_sr, f_hr.detach())
    adv = -d(sr).float().mean()
    loss_g = (r["weight_pixel"] * pixel + r["weight_content"] * content
              + r["weight_gan"] * adv)
    g_grads = torch.autograd.grad(loss_g, g_params)

    sr = sr.detach().float()
    loss_d = -d(hr).float().mean() + d(sr).float().mean()
    interp = (alpha * hr + (1 - alpha) * sr).requires_grad_(True)
    (grad,) = torch.autograd.grad(d(interp).float().sum(), interp,
                                  create_graph=True)
    gp = ((torch.sqrt((grad * grad).sum(1) + 1e-12) - 1) ** 2).mean()
    d_grads = torch.autograd.grad(loss_d + (r["lambda_gp"] + 1) * gp,
                                  d_params)
    losses = {"pixel": pixel, "content": content, "loss_G": loss_g,
              "loss_D": loss_d + r["lambda_gp"] * gp}
    return losses, (list(g_grads), list(d_grads))


class ReferenceStep:
    """G and its Adam, and for WGAN-GP the D with its Adam and VGG19, from
    the benchmark's weights."""

    def __init__(self, config: Mapping, weights: Mapping[str, Mapping],
                 device, numerics: Numerics = EXACT):
        self.recipe = config["recipe"]
        self.bf16 = bool(config["precision"]["train_bf16"])
        self.g = set_numerics(build_generator(config, device), numerics)
        self.d = self.vgg = None
        if adversarial(config):
            self.d = set_numerics(build("discriminator", device), numerics)
            self.vgg = set_numerics(build("vgg", device), numerics)
            self.vgg.load_state_dict(weights["vgg"])
            self.vgg.train().requires_grad_(False)
        for key, net in self.nets().items():
            net.load_state_dict(weights[key])
            net.train()
        r = self.recipe
        self.opts = [torch.optim.Adam(net.parameters(), lr=r["lr"],
                                      betas=tuple(r["betas"]), eps=r["eps"])
                     for net in self.nets().values()]

    def nets(self) -> Dict[str, torch.nn.Module]:
        """The trained networks by key: "g", and "d" for WGAN-GP."""
        return {k: n for k, n in (("g", self.g), ("d", self.d))
                if n is not None}

    def step(self, lr: torch.Tensor, hr: torch.Tensor,
             alpha: Optional[torch.Tensor],
             g_grads: Optional[Callable] = None) -> Dict:
        """One step on NCHW float32 batches (``alpha``: the penalty's
        weights, None for a pixel-only step); returns the losses as floats
        and the gradients applied, by network and parameter name.
        ``g_grads`` changes the G's gradients before its update (a planted
        fault)."""
        if self.d is None:
            losses, grads = pixel_only(self.g, self.recipe, lr, hr,
                                       self.bf16)
        else:
            losses, grads = wgan_gp(self.g, self.d, self.vgg, self.recipe,
                                    lr, hr, alpha, self.bf16)
        if g_grads is not None:
            grads = (g_grads(grads[0]),) + tuple(grads[1:])
        for opt, net, net_grads in zip(self.opts, self.nets().values(),
                                       grads):
            for p, g in zip(net.parameters(), net_grads):
                p.grad = g
            opt.step()
        if self.d is not None:
            with torch.no_grad():
                for p in self.d.parameters():
                    p.clamp_(-self.recipe["clip"], self.recipe["clip"])
        names = {key: [n for n, _ in net.named_parameters()]
                 for key, net in self.nets().items()}
        return {"losses": {k: float(v.detach()) for k, v in losses.items()},
                "grads": {key: dict(zip(names[key], g))
                          for key, g in zip(names, grads)}}

    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {key: dict(net.named_parameters())
                for key, net in self.nets().items()}


def follow(config: Mapping, weights: Mapping, batches: Sequence,
           alphas: Sequence, device, numerics: Numerics = EXACT,
           g_grads: Optional[Callable] = None,
           schedule: Optional[List] = None) -> Dict:
    """The reference over the checked steps: each step's losses, the first
    step's gradient norms, and the parameters' change norms after the first
    step and after the last, by network and parameter name.  ``alphas``:
    the penalty's weights of each step (None each for a pixel-only step).
    ``schedule``: a list that receives the first step's calls of the six
    functions (``port_bench.schedule``) in the trained networks."""
    ref = ReferenceStep(config, weights, device, numerics)

    def change():
        return {net: {n: float((p.detach() - weights[net][n]).norm())
                      for n, p in ps.items()}
                for net, ps in ref.params().items()}
    losses, grad_norms, change1 = [], None, None
    for i, ((lr, hr), alpha) in enumerate(zip(batches, alphas)):
        with recording(*ref.nets().values()) as calls:
            out = ref.step(lr.to(device), hr.to(device),
                           None if alpha is None else alpha.to(device),
                           g_grads)
        if i == 0 and schedule is not None:
            schedule += calls
        losses.append(out["losses"])
        if i == 0:
            grad_norms = {net: {n: float(g.norm()) for n, g in gs.items()}
                          for net, gs in out["grads"].items()}
            change1 = change()
        del out
    return {"losses": losses, "grad_norms": grad_norms,
            "change1_norms": change1, "change_norms": change()}


def bucket_of(buckets: Sequence[int], h: int, w: int) -> int:
    """The smallest bucket that holds an (h, w) input."""
    return min(s for s in buckets if s >= max(h, w))


@torch.no_grad()
def serve(generator: torch.nn.Module, lr01: np.ndarray,
          buckets: Sequence[int], scale: int, device) -> np.ndarray:
    """A served request as published: the (B, H, W, C) [0, 1] batch
    reflect-padded at the bottom and right up to its bucket, the
    generator's forward, the SR cropped back to (B, sH, sW, C)."""
    b, h, w, _ = lr01.shape
    s = bucket_of(buckets, h, w)
    padded = np.pad(lr01, ((0, 0), (0, s - h), (0, s - w), (0, 0)),
                    mode="reflect")
    x = torch.from_numpy(np.ascontiguousarray(padded.transpose(0, 3, 1, 2)))
    y = generator(x.to(device, torch.float32))
    return y[:, :, :h * scale, :w * scale].permute(0, 2, 3, 1).cpu().numpy()
