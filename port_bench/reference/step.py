"""The plain reference of one WGAN-GP train step, and of a served request.

The step is the published recipe (``main_sradsgan.py:31-58``): the G loss
``w_pixel * L1(sr, hr) + w_content * L1(VGG(sr), VGG(hr)) - w_gan *
mean(D(sr))`` and one Adam step on G; then the D loss ``-mean(D(hr)) +
mean(D(sr))`` plus the gradient penalty on random interpolates (the norm of
D's input gradient over the channels at each pixel, ``(norm - 1)^2``
averaged), whose gradient the reference applies ``lambda + 1`` times while
the logged loss carries ``lambda``; one Adam step on D, then every D
parameter clipped to ``+-clip``.  BatchNorm layers run in train mode over
the whole batch.  Nothing of the program.  In the configuration's mixed precision the
forwards run under bf16 autocast (``models.py``), the losses in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from port_bench.reference.models import EXACT, Numerics, build, set_numerics
from port_bench.schedule import recording


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


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
    sr = g(lr)
    pixel = l1(sr.float(), hr)
    f_sr, f_hr = vgg(torch.cat([sr.float(), hr])).float().chunk(2)
    content = l1(f_sr, f_hr.detach())
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
    """G, D, VGG19 and their two Adams, from the benchmark's weights."""

    def __init__(self, config: Mapping, weights: Mapping[str, Mapping],
                 device, numerics: Numerics = EXACT):
        widths = config["widths"]
        self.recipe = config["recipe"]
        self.bf16 = bool(config["precision"]["train_bf16"])
        self.g = set_numerics(build(config["model"], device, **widths),
                              numerics)
        self.d = set_numerics(build("discriminator", device), numerics)
        self.vgg = set_numerics(build("vgg", device), numerics)
        for net, key in ((self.g, "g"), (self.d, "d"), (self.vgg, "vgg")):
            net.load_state_dict(weights[key])
            net.train()
        self.vgg.requires_grad_(False)
        r = self.recipe
        self.g_opt, self.d_opt = (
            torch.optim.Adam(net.parameters(), lr=r["lr"],
                             betas=tuple(r["betas"]), eps=r["eps"])
            for net in (self.g, self.d))

    def step(self, lr: torch.Tensor, hr: torch.Tensor,
             alpha: torch.Tensor, g_grads: Optional[Callable] = None
             ) -> Dict:
        """One step on NCHW float32 batches; returns the losses as floats
        and the gradients applied, by network and parameter name.
        ``g_grads`` changes the G's gradients before its update (a planted
        fault)."""
        losses, grads = wgan_gp(self.g, self.d, self.vgg, self.recipe, lr,
                                hr, alpha, self.bf16)
        if g_grads is not None:
            grads = (g_grads(grads[0]), grads[1])
        for opt, net, net_grads in ((self.g_opt, self.g, grads[0]),
                                    (self.d_opt, self.d, grads[1])):
            for p, g in zip(net.parameters(), net_grads):
                p.grad = g
            opt.step()
        with torch.no_grad():
            for p in self.d.parameters():
                p.clamp_(-self.recipe["clip"], self.recipe["clip"])
        names = ([n for n, _ in net.named_parameters()]
                 for net in (self.g, self.d))
        return {"losses": {k: float(v.detach()) for k, v in losses.items()},
                "grads": {key: dict(zip(n, g)) for key, n, g
                          in zip(("g", "d"), names, grads)}}

    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"g": dict(self.g.named_parameters()),
                "d": dict(self.d.named_parameters())}


def follow(config: Mapping, weights: Mapping, batches: Sequence,
           alphas: Sequence, device, numerics: Numerics = EXACT,
           g_grads: Optional[Callable] = None,
           schedule: Optional[List] = None) -> Dict:
    """The reference over the checked steps: each step's losses, the first
    step's gradient norms, and the parameters' change norms after the first
    step and after the last, by network and parameter name.  ``schedule``:
    a list that receives the first step's calls of the six functions
    (``port_bench.schedule``)."""
    ref = ReferenceStep(config, weights, device, numerics)

    def change():
        return {net: {n: float((p.detach() - weights[net][n]).norm())
                      for n, p in ps.items()}
                for net, ps in ref.params().items()}
    losses, grad_norms, change1 = [], None, None
    for i, ((lr, hr), alpha) in enumerate(zip(batches, alphas)):
        with recording(ref.g, ref.d) as calls:
            out = ref.step(lr.to(device), hr.to(device), alpha.to(device),
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
