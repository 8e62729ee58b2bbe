"""The trainer of the model zoo in PyTorch: the train step, the validation
sweep and the epoch loop with plateau backtracking.

Counterpart of ``sradsgan_tpu/train/trainer.py:Trainer``, for the models of
the port's registry (``models/__init__.py``), whose recipe picks the
losses: the pixel-only models (EDSR, DSSR, AMSSRN) have no discriminator
and no VGG, their step is the G step's pixel term alone; lsgan (SRGAN,
NDSRGAN) has neither penalty nor clip; WGAN-GP (DRCAN, SRAGAN, SRADSGAN)
both.  One step:

- **G step.** ``sr = G(lr)``; loss = ``w_pixel * pixel(sr, hr)`` + ``w_content
  * pixel(VGG(sr), VGG(hr))`` (the HR features carry no gradient) +
  ``w_gan * adversarial_g(D(sr))``; one Adam step on G.
- **D step.** ``adversarial_d(D(hr), D(sr.detach()))`` plus, for WGAN-GP,
  the gradient penalty on interpolates with gradient weight ``lambda + 1``
  (the reference backprops the penalty twice), while the logged ``loss_D``
  carries ``lambda``; one Adam step on D, then every D parameter clipped to
  ``+-clip_value``.

The discriminator runs the reference's train-mode forwards (sr in the G
step, then hr, sr.detach() and, for WGAN-GP, the interpolates), each
updating the BatchNorm running statistics.  The JAX WGAN-GP step shares the
first two and replays the second BatchNorm update in closed form
(``trainer.py:313-322``), so the running statistics agree to a tolerance,
not bit for bit; its lsgan step keeps the D's statistics of hr and sr only
(``trainer.py:259-266``), one update a step fewer than here.  A generator
with BatchNorm (SRGAN, SRAGAN) is in train mode in the step (its running
statistics update once a forward, the shared upsample BatchNorm once a
stage) and in eval mode in the sweep; the plateau reload restores its
whole ``state_dict``, running statistics included, as the reference does
(the JAX trainer reloads its params only).

Precision: float32 (``cfg.bf16`` off, the parity mode), or the JAX
default's mixed precision: bf16 generator and VGG convs under autocast
(``cfg.bf16``), bf16 discriminator convs (``cfg.d_bf16`` as well), over
float32 parameters, float32 BatchNorm and float32 gate and softmax math
inside the kernels' ops.  A CPU trainer whose networks are cast with
``.double()`` takes the whole step in float64, the reference that
``chip_smoke.py`` holds the card's float32 step to.

A step takes a batch as a dict of ``lr`` and ``hr`` in [0, 1]: NHWC float32
numpy arrays, as ``bench.py`` feeds the JAX trainer, or the NCHW tensors the
data feed (``data/loader.py:device_prefetch``) hands out.

CUDA graphs.  On a CUDA device in a process without a data mesh, the step
replays from a ``torch.cuda.CUDAGraph`` instead of launching its thousands
of kernels one by one from the host.  The first step of a key (the input
shapes and dtypes and each optimizer's lr) runs eagerly: cuDNN chooses its
algorithms, Adam builds its state.  The second captures the whole step (G,
VGG19, the D, both gradients and Adams, the penalty's grad of grad, the
clip, the losses) into a private memory pool, with autocast's weight cache
off, and replays it; every later step copies the images and the penalty's
weights (still drawn on the CPU from the same generator, in the same
order) into the graph's static tensors and replays it.  A new key runs
eagerly and captures anew; :meth:`Trainer.load_checkpoint`, the chain
initialization and the plateau reload drop the graph.  The Adams are built
``capturable`` on that path (``train/state.py``).  The CPU and a data mesh
step eagerly; :attr:`Trainer.graphed` holds the decision, made once at
construction, and :attr:`Trainer.graph_stats` counts the steps of each
kind.  Every step draws the penalty's weights the same way
(:meth:`Trainer._penalty_draw`).

:meth:`Trainer.train` is the epoch loop of the JAX ``Trainer.train``: a
loader per epoch seeded ``cfg.seed + epoch``, a log line every 50 steps, the
``sample_interval`` evaluation of the current batch against its bicubic
twin, the epoch-end validation sweep (:meth:`Trainer.validate`), the
reference's best-metric chain, per-epoch checkpoints and ``ckpt_best.pt``,
step decay, the plateau backtrack, the lr-floor stop, and chain
initialization from ``cfg.init_from`` (:func:`partial_restore`).  Its
TensorBoard sinks (``logs/`` under ``cfg.model_dir``, where tensorboardX
imports) are the JAX trainer's: the step's losses as scalars every 50
steps, the first image's SR, HR and bicubic twin at ``sample_interval``,
and at each epoch's end histograms ``g_params`` and ``d_params`` of the
first 2048 values of every parameter tensor (in the port's OIHW layout and
registration order, so that their values differ from JAX's HWIO leaves);
after the last epoch ``train_curves.png`` (where matplotlib imports).
``steps_per_call`` is not ported.

Data parallelism (``cfg.num_devices``; ``parallel/mesh.py``): under
``torchrun`` each rank holds the whole models and steps on its rows of the
global batch (``cfg.data.batch_size``, as in JAX), so that W ranks take the
step one process takes at that batch, the JAX package's sharded step:
:meth:`train_step` takes a global batch and keeps this rank's rows, the
penalty's interpolation weights are drawn for the global batch and sliced
alike, the gradients are averaged over the ranks before each optimizer step
(so the D's weight clip stays the same on every rank), BatchNorm in train
mode takes the global batch's statistics, and the returned losses are means
over the ranks.  The epoch loop feeds each rank its shard of the shuffled
order (the same number of steps on every rank), the sweep sums each
rank's images once and adds the sums over the ranks, every rank takes the
plateau and best-metric decisions from the same numbers, and rank 0 alone
writes checkpoints and logs, each write followed by a barrier.  The
relativistic losses, whose batch means would be the rank's, are refused on
more than one rank.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sradsgan_tpu_torch.config import TrainConfig
from sradsgan_tpu_torch.data.datasets import (build_test_dataset,
                                              build_train_dataset)
from sradsgan_tpu_torch.data.loader import DataLoader, device_prefetch
from sradsgan_tpu_torch.losses import gan as gan_losses
from sradsgan_tpu_torch.losses.lpips import batched_lpips
from sradsgan_tpu_torch.losses.pixel import pixel_loss
from sradsgan_tpu_torch.losses.vgg import load_vgg19
from sradsgan_tpu_torch.metrics.fidelity import (batched_ergas, batched_psnr,
                                                 batched_ssim)
from sradsgan_tpu_torch.models import create_generator, get_spec
from sradsgan_tpu_torch.ops import plain_dtype
from sradsgan_tpu_torch.parallel.mesh import (Mesh, all_reduce_grads_,
                                              all_reduce_sums, create_mesh,
                                              replicate, shard_batch)
from sradsgan_tpu_torch.train.state import (get_lr, make_optimizer,
                                            set_capturable, set_lr)
from sradsgan_tpu_torch.utils.logging import Logger
from sradsgan_tpu_torch.utils.plotting import plot_curves
from sradsgan_tpu_torch.utils.spans import span

Batch = Mapping[str, Any]
# The sweep's per-image metrics (:meth:`Trainer._eval_step`); with
# ``cfg.val_lpips`` also LPIPS_METRICS.
EVAL_METRICS = ("psnr", "ssim", "ergas", "bc_psnr", "bc_ssim")
LPIPS_METRICS = ("lpips", "bc_lpips")


class _First:
    """The first ``n`` images of a dataset."""

    def __init__(self, dataset, n: int):
        self.dataset, self.n = dataset, min(n, len(dataset))

    def __len__(self) -> int:
        return self.n

    def load(self, index: int, rng=None):
        return self.dataset.load(index, rng)


def partial_restore(model: nn.Module,
                    source: Mapping[str, torch.Tensor]) -> Tuple[int, int]:
    """Copy into ``model`` every parameter of ``source`` whose name and
    shape match; the others keep their present values, and buffers
    (BatchNorm running statistics) are left alone, as the JAX package's
    ``partial_restore`` merges params only.  Chain training restores
    everything but the upsample tail, whose conv widths differ between
    scale families.  Returns the (kept, re-initialized) counts."""
    kept = skipped = 0
    with torch.no_grad():
        for name, param in model.named_parameters():
            src = source.get(name)
            if src is not None and src.shape == param.shape:
                param.copy_(src)
                kept += 1
            else:
                skipped += 1
    return kept, skipped


def _graphable(device: torch.device, mesh: Mesh) -> bool:
    """Whether a trainer on ``device`` in ``mesh`` replays its step from a
    CUDA graph: on a CUDA device in a process without a group (the CPU and
    a data mesh, whose collectives a graph would not hold, step eagerly)."""
    return device.type == "cuda" and mesh.group is None


class _StepGraph:
    """One train step captured into a CUDA graph: its key, the static
    inputs its replays read (the images; the penalty's weights, None
    without a penalty) and the losses they write."""

    def __init__(self, key: tuple, lr_img: torch.Tensor,
                 hr_img: torch.Tensor, alpha: Optional[torch.Tensor]):
        self.key, self.lr, self.hr, self.alpha = key, lr_img, hr_img, alpha
        self.graph = torch.cuda.CUDAGraph()
        self.losses: Dict[str, torch.Tensor] = {}

    def replay(self, lr_img: Optional[torch.Tensor] = None,
               hr_img: Optional[torch.Tensor] = None,
               alpha: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """Copy the step's inputs in (``alpha`` on the CPU, copied without
        waiting for the device), replay, and return copies of the losses,
        which the next replay overwrites."""
        if lr_img is not None:
            self.lr.copy_(lr_img)
            self.hr.copy_(hr_img)
        if alpha is not None:
            self.alpha.copy_(alpha.pin_memory(), non_blocking=True)
        self.graph.replay()
        return {k: v.clone() for k, v in self.losses.items()}


class Trainer:
    """Models, optimizers and the step of one GAN (or pixel-only) model.

    Weights are drawn from seeds derived from ``cfg.seed``: the generator
    from ``seed``, the discriminator from ``seed + 1``, the VGG features
    (without ``SRADSGAN_TPU_VGG19_NPZ``) from ``seed + 2``; the penalty's
    interpolation weights from a CPU ``torch.Generator`` seeded with
    ``seed + 1`` unless a step is given its own.  Every rank of a data mesh
    draws the same weights; rank 0's are broadcast all the same.
    """

    def __init__(self, cfg: TrainConfig, device: torch.device | str = "cuda"):
        if (torch.device(device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                f"Trainer(device={str(device)!r}) needs a CUDA device and "
                "this torch sees none; pass device='cpu' to train on the CPU")
        self.mesh = create_mesh(cfg.num_devices, device)
        self.device = self.mesh.device
        if cfg.gan.relativistic and self.mesh.world > 1:
            raise NotImplementedError(
                "the relativistic GAN losses take batch means that a data "
                "mesh would split; train them in one process")
        self.cfg = cfg
        self.spec = get_spec(cfg.model)
        self.g_bf16 = cfg.bf16
        self.d_bf16 = cfg.bf16 and cfg.d_bf16
        # the steps taken eagerly, captured into a graph and replayed from it
        self.graph_stats = {"eager": 0, "captured": 0, "replayed": 0}
        # decided once: the Adams are built capturable for it
        self.graphed = _graphable(self.device, self.mesh)
        self._graph: Optional[_StepGraph] = None
        self._warm_key: Optional[tuple] = None  # the last eager step's

        self.generator = create_generator(
            cfg.model, cfg.scale, num_channels=cfg.num_channels,
            seed=cfg.seed, device=self.device, **cfg.model_kwargs).train()
        self.discriminator: Optional[nn.Module] = None
        self.vgg: Optional[nn.Module] = None
        self.d_opt: Optional[torch.optim.Optimizer] = None
        if self.spec.adversarial:
            self.discriminator = self.spec.discriminator(
                num_channels=cfg.num_channels, seed=cfg.seed + 1,
                device=self.device).train()
            if cfg.gan.weight_content > 0:
                self.vgg = load_vgg19(seed=cfg.seed + 2, device=self.device)
        if cfg.init_from:
            self._chain_init(cfg.init_from)
        self._replicate()
        o = cfg.optim
        self.g_opt = make_optimizer(self.generator.parameters(), o.lr, o.b1,
                                    o.b2, self.graphed)
        if self.discriminator is not None:
            self.d_opt = make_optimizer(self.discriminator.parameters(),
                                        o.lr, o.b1, o.b2, self.graphed)
        self.alpha_generator = torch.Generator().manual_seed(cfg.seed + 1)
        self.step = 0
        self.logger = Logger(cfg.model, os.path.join(cfg.model_dir, "logs"),
                             use_tensorboard=self.mesh.is_main)
        self.history: Dict[str, list] = {}
        # seconds the last epoch of train() took, and of those the seconds
        # its loop waited on the data feed
        self.feed_stats: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def _chain_init(self, path: str) -> None:
        """Warm-start from a checkpoint of another scale: the generator's
        and the discriminator's parameters where name and shape match (the
        discriminator's running statistics stay fresh, as the JAX package
        leaves them)."""
        self._drop_graph()
        prev = torch.load(path, map_location=self.device, weights_only=True)
        kept, skipped = partial_restore(self.generator, prev["generator"])
        if self.mesh.is_main:
            print(f"chain init from {path}: kept {kept} leaves, "
                  f"re-initialized {skipped}")
        if self.discriminator is not None and "discriminator" in prev:
            partial_restore(self.discriminator, prev["discriminator"])

    def _replicate(self) -> None:
        """Every rank's G and D made rank 0's."""
        for net in (self.generator, self.discriminator):
            if net is not None:
                replicate(net, self.mesh)

    def _drop_graph(self) -> None:
        """Forget the captured step: the next step runs eagerly, the one
        after it captures anew."""
        self._graph = self._warm_key = None

    def _log(self, mode: str, results: Dict[str, Any]) -> None:
        if self.mesh.is_main:
            self.logger.print_format_results(mode, results)

    def _autocast(self, bf16: bool):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=bf16)

    def _to_device(self, x) -> torch.Tensor:
        """An NHWC numpy array or an NCHW tensor -> NCHW on the device, in
        the generator's parameter dtype (float32; float64 for a reference
        trainer)."""
        dtype = next(self.generator.parameters()).dtype
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype).contiguous()
        t = torch.from_numpy(np.asarray(x, np.float32)).to(self.device, dtype)
        return t.permute(0, 3, 1, 2).contiguous()

    def _d(self, x: torch.Tensor) -> torch.Tensor:
        """A train-mode D forward in the D's precision."""
        with self._autocast(self.d_bf16):
            return self.discriminator(x.to(plain_dtype(x)))

    def _update(self, opt: torch.optim.Optimizer, model: nn.Module,
                loss: torch.Tensor, backward: str, optim: str,
                clip: Optional[float] = None) -> None:
        """Gradients of ``loss`` for ``model``'s parameters alone (the span
        ``backward``), averaged over the ranks and left in their ``.grad``,
        then one optimizer step and, with ``clip``, every parameter clipped
        to ``+-clip`` (the span ``optim``)."""
        params = [p for p in model.parameters() if p.requires_grad]
        with span(backward):
            for p, g in zip(params, torch.autograd.grad(loss, params)):
                p.grad = g
        with span(optim):
            all_reduce_grads_(params, self.mesh)
            opt.step()
            if clip is not None:
                with torch.no_grad():
                    for p in model.parameters():
                        p.clamp_(-clip, clip)

    # ------------------------------------------------------------------
    def train_step(self, batch: Batch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One G and one D update on a global batch, of which this rank
        takes its rows.  ``generator`` draws the penalty's interpolation
        weights (default: the trainer's own).  Returns the step's losses,
        means over the ranks, as 0-dim tensors on the device (reading them
        waits for the device); each parameter's ``.grad`` holds the
        gradient the step applied."""
        return self._local_step(shard_batch(batch, self.mesh), generator)

    def _local_step(self, batch: Batch,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
        """:meth:`train_step` on this rank's rows of the global batch:
        eagerly, captured into a graph, or replayed from it (see the
        module's docstring)."""
        with span("train.step"):
            lr_img = self._to_device(batch["lr"])
            hr_img = self._to_device(batch["hr"])
            alpha = self._penalty_draw(lr_img.shape[0],
                                       generator or self.alpha_generator)
            key = self._graph_key(lr_img, hr_img)
            graph = self._graph
            if key is not None and graph is not None and graph.key == key:
                self.graph_stats["replayed"] += 1
                with span("train.replay"):
                    losses = graph.replay(lr_img, hr_img, alpha)
            elif key is not None and key == self._warm_key:
                self.graph_stats["captured"] += 1
                with span("train.capture"):
                    self._graph = graph = self._capture(key, lr_img, hr_img,
                                                        alpha)
                with span("train.replay"):
                    losses = graph.replay()
            else:
                self.graph_stats["eager"] += 1
                self._graph, self._warm_key = None, key
                losses = self._step_losses(
                    lr_img, hr_img,
                    None if alpha is None else alpha.to(self.device))
            self.step += 1
            return losses

    def _step_losses(self, lr_img: torch.Tensor, hr_img: torch.Tensor,
                     alpha: Optional[torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The G and D updates of one step, the penalty's weights ``alpha``
        on the device (:meth:`_penalty_draw`), and its losses, means over
        the ranks."""
        metrics: Dict[str, torch.Tensor] = {}
        sr = self._g_step(lr_img, hr_img, metrics)
        if self.discriminator is not None:
            self._d_step(hr_img, sr.detach(), alpha, metrics)
        means = (all_reduce_sums(metrics.values(), self.mesh)
                 / self.mesh.world)
        return {k: m.to(v.dtype)
                for (k, v), m in zip(metrics.items(), means.unbind())}

    def _graph_key(self, lr_img: torch.Tensor,
                   hr_img: torch.Tensor) -> Optional[tuple]:
        """What a captured step is good for: the images' shapes and dtypes
        and each optimizer's lr (None where the step is not graphed)."""
        if not self.graphed:
            return None
        lrs = tuple(group["lr"] for opt in (self.g_opt, self.d_opt)
                    if opt is not None for group in opt.param_groups)
        return (lr_img.shape, lr_img.dtype, hr_img.shape, hr_img.dtype, lrs)

    def _penalty_draw(self, batch: int, generator: torch.Generator
                      ) -> Optional[torch.Tensor]:
        """The penalty's weights of this rank's ``batch`` rows, on the CPU:
        the global batch's draws from ``generator``, this rank's rows (None
        without a penalty)."""
        if (self.discriminator is None
                or self.cfg.gan.gan_type != "wgan-gp"):
            return None
        mesh = self.mesh
        return gan_losses.interpolation_weights(
            batch * mesh.world, generator, "cpu")[mesh.rank::mesh.world]

    def _capture(self, key: tuple, lr_img: torch.Tensor,
                 hr_img: torch.Tensor,
                 alpha: Optional[torch.Tensor]) -> _StepGraph:
        """The step captured into a CUDA graph whose static inputs hold
        this step's images and penalty weights (``alpha``, on the CPU);
        nothing runs until it is replayed.  The parameters' gradients are
        the graph's own from its first replay."""
        static = _StepGraph(key, lr_img.clone(), hr_img.clone(),
                            None if alpha is None else alpha.to(self.device))
        for net in (self.generator, self.discriminator):
            if net is not None:
                for p in net.parameters():
                    p.grad = None
        # autocast's weight cache would hold casts across the capture's end
        cache = torch.is_autocast_cache_enabled()
        torch.set_autocast_cache_enabled(False)
        try:
            # thread-local: the data feed's thread works on during capture
            with torch.cuda.graph(static.graph,
                                  capture_error_mode="thread_local"):
                static.losses = self._step_losses(static.lr, static.hr,
                                                  static.alpha)
        finally:
            torch.set_autocast_cache_enabled(cache)
        return static

    def _g_step(self, lr_img: torch.Tensor, hr_img: torch.Tensor,
                metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
        gan = self.cfg.gan
        with span("train.g_forward"), self._autocast(self.g_bf16):
            sr = self.generator(lr_img)
            p_loss = pixel_loss(sr, hr_img, self.spec.pixel_loss)
            loss = gan.weight_pixel * p_loss
            metrics["pixel"] = p_loss
            if self.vgg is not None:
                with span("train.vgg"):
                    feats = self.vgg(torch.cat([sr, hr_img]))
                    feat_sr, feat_hr = feats.chunk(2)
                    c_loss = pixel_loss(feat_sr, feat_hr.detach(),
                                        self.spec.pixel_loss)
                loss = loss + gan.weight_content * c_loss
                metrics["content"] = c_loss
            if self.discriminator is not None:
                fake = self._d(sr)
                real = self._d(hr_img) if gan.relativistic else None
                adv = gan_losses.adversarial_loss_g(
                    fake, gan.gan_type, real_logits=real,
                    relativistic=gan.relativistic)
                loss = loss + gan.weight_gan * adv
                metrics["adv_g"] = adv
        self._update(self.g_opt, self.generator, loss, "train.g_backward",
                     "train.g_optim")
        metrics["loss_G"] = loss
        return sr

    def _d_step(self, hr_img: torch.Tensor, sr: torch.Tensor,
                alpha: Optional[torch.Tensor],
                metrics: Dict[str, torch.Tensor]) -> None:
        gan = self.cfg.gan
        wgan_gp = gan.gan_type == "wgan-gp"
        with span("train.d_forward"):
            loss = gan_losses.adversarial_loss_d(
                self._d(hr_img), self._d(sr), gan.gan_type,
                relativistic=gan.relativistic)
            objective = loss
            if wgan_gp:
                with span("train.penalty"):
                    gp = gan_losses.gradient_penalty(self._d, hr_img, sr,
                                                     alpha)
                gp_weight = gan.lambda_gp + (1.0 if gan.gp_inner_backward
                                             else 0.0)
                objective = loss + gp_weight * gp
                loss = loss + gan.lambda_gp * gp
        # WGAN-GP clips every D parameter after the step
        self._update(self.d_opt, self.discriminator, objective,
                     "train.d_backward", "train.d_optim",
                     clip=gan.clip_value if wgan_gp else None)
        metrics["loss_D"] = loss

    def run_steps(self, batches: Iterable[Batch],
                  num_steps: int) -> Dict[str, float]:
        """Up to ``num_steps`` steps over caller-made ``batches``; the last
        step's losses as floats."""
        metrics: Dict[str, torch.Tensor] = {}
        for _, batch in zip(range(num_steps), batches):
            metrics = self.train_step(batch)
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------------
    # Evaluation: per-image PSNR / SSIM / ERGAS against HR, and the twin's
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _eval_sr(self, lr) -> torch.Tensor:
        """G(lr) in eval mode and the generator's precision, as float32."""
        was_training = self.generator.training
        self.generator.eval()
        try:
            with self._autocast(self.g_bf16):
                sr = self.generator(self._to_device(lr))
        finally:
            self.generator.train(was_training)
        return sr.float()

    @torch.no_grad()
    def _eval_step(self, batch: Batch,
                   keep_sr: bool = False) -> Dict[str, torch.Tensor]:
        """Per-image metrics of G(lr) and of the bicubic twin against hr,
        each (B,) on the device; with ``cfg.val_lpips`` also ``lpips`` and
        ``bc_lpips`` (AlexNet LPIPS in float32, on the raw SR), so that the
        sweep carries all five of the reference's metrics
        (``sradsgan.py:1484-1496``); with ``keep_sr`` also ``sr``, the SR
        batch."""
        hr_img, bc_img = (self._to_device(batch[k]) for k in ("hr", "bc"))
        sr = self._eval_sr(batch["lr"])
        out = {"psnr": batched_psnr(sr, hr_img),
               "ssim": batched_ssim(sr, hr_img),
               "ergas": batched_ergas(sr, hr_img, self.cfg.scale),
               "bc_psnr": batched_psnr(bc_img, hr_img),
               "bc_ssim": batched_ssim(bc_img, hr_img)}
        if self.cfg.val_lpips:
            out["lpips"] = batched_lpips(sr, hr_img)
            out["bc_lpips"] = batched_lpips(bc_img, hr_img)
        if keep_sr:
            out["sr"] = sr
        return out

    def validate(self, max_batches: Optional[int] = None) -> Dict[str, float]:
        """Means of :meth:`_eval_step`'s metrics over the test set (its
        first ``max_batches`` batches of ``cfg.data.test_batch_size``
        images), each image counted once: each rank sweeps its stride of
        the images, and the sums and the count are added over the ranks
        after the sweep, so a rank with fewer images waits for the others
        only there."""
        cfg, mesh = self.cfg, self.mesh
        dataset = build_test_dataset(cfg.data, cfg.scale)
        if max_batches is not None:
            dataset = _First(dataset, max_batches * cfg.data.test_batch_size)
        local_batch = -(-cfg.data.test_batch_size // mesh.world)
        loader = DataLoader(dataset, local_batch, shuffle=False,
                            drop_last=False,
                            num_workers=cfg.data.num_workers,
                            shard_index=mesh.rank, shard_count=mesh.world)
        keys = EVAL_METRICS + (LPIPS_METRICS if cfg.val_lpips else ())
        sums = {k: torch.zeros((), dtype=torch.float64, device=self.device)
                for k in keys}
        count = 0
        feed = device_prefetch(iter(loader), self.device)
        try:
            for batch in feed:
                for k, v in self._eval_step(batch).items():
                    sums[k] = sums[k] + v.double().sum()
                count += batch["lr"].shape[0]
        finally:
            feed.close()
        totals = all_reduce_sums(list(sums.values()) + [count], mesh).tolist()
        return {k: v / max(totals[-1], 1) for k, v in zip(keys, totals)}

    # ------------------------------------------------------------------
    # The epoch loop with plateau backtracking
    # ------------------------------------------------------------------
    def _save(self, state: Dict[str, Any], path: str) -> None:
        """``torch.save`` on rank 0, then a barrier, so that any rank may
        read the file next."""
        if self.mesh.is_main:
            torch.save(state, path)
        self.mesh.barrier()

    def _save_best(self, path: str) -> None:
        state = {"generator": self.generator.state_dict()}
        if self.discriminator is not None:
            state["discriminator"] = self.discriminator.state_dict()
        self._save(state, path)

    def _sample_summary(self, batch: Batch, sr: torch.Tensor,
                        step: int) -> None:
        """The first image's SR, HR and bicubic twin as TensorBoard
        images, as the JAX trainer writes them."""
        def hwc(t):
            return t[0].float().permute(1, 2, 0).cpu().numpy()
        self.logger.image_summary(
            "sample/sr_hr_bicubic",
            [hwc(sr)] + [hwc(self._to_device(batch[k])) for k in ("hr", "bc")],
            step)

    def _param_histograms(self, step: int) -> None:
        """The first 2048 values of each parameter tensor of G and of D,
        concatenated, as TensorBoard histograms."""
        for tag, model in (("g_params", self.generator),
                           ("d_params", self.discriminator)):
            if model is not None:
                self.logger.histo_summary(tag, np.concatenate(
                    [p.detach().float().cpu().numpy().ravel()[:2048]
                     for p in model.parameters()]), step)

    def train(self, num_steps: Optional[int] = None) -> Dict[str, float]:
        """Train for ``cfg.num_epochs`` epochs and return the last
        validation sweep's metrics, or, with ``num_steps``, stop after that
        many steps (the epoch cap lifted) and return the last step's
        losses."""
        try:
            return self._train(num_steps)
        finally:
            self.logger.close()

    def _train(self, num_steps: Optional[int]) -> Dict[str, float]:
        cfg, mesh = self.cfg, self.mesh
        os.makedirs(cfg.model_dir, exist_ok=True)
        dataset = build_train_dataset(cfg.data, cfg.scale)
        if cfg.data.batch_size % mesh.world:
            raise ValueError(
                f"batch_size {cfg.data.batch_size} (the global batch) does "
                f"not split over {mesh.world} ranks")

        # the reference's maxima init: 0 / 0 / 10000
        best = {"psnr": 0.0, "ssim": 0.0, "ergas": 10000.0}
        best_path = os.path.join(cfg.model_dir, "ckpt_best.pt")
        best_epoch = cfg.start_epoch
        bad_epochs = 0
        step_count = 0
        t0 = time.time()
        last_metrics: Dict[str, float] = {}
        metrics: Dict[str, torch.Tensor] = {}
        self.history = {"loss_G": [], "loss_D": [], "psnr": [], "ssim": [],
                        "ergas": []}

        max_epochs = cfg.num_epochs if num_steps is None else 10 ** 9
        epoch = cfg.start_epoch
        while epoch < max_epochs:
            lr_now = get_lr(self.g_opt)
            if lr_now < cfg.optim.lr_floor:  # the reference's stop rule
                if mesh.is_main:
                    print(f"lr {lr_now:.2e} below floor; stopping")
                break
            loader = DataLoader(dataset, cfg.data.batch_size // mesh.world,
                                shuffle=True, drop_last=True,
                                num_workers=cfg.data.num_workers,
                                seed=cfg.seed + epoch, shard_index=mesh.rank,
                                shard_count=mesh.world)
            feed = device_prefetch(iter(loader), self.device)
            epoch_t0 = time.time()
            waited = 0.0
            try:
                while True:
                    wait_t0 = time.time()
                    batch = next(feed, None)
                    waited += time.time() - wait_t0
                    if batch is None:
                        break
                    metrics = self._local_step(batch)
                    step_count += 1
                    if step_count % 50 == 0:
                        m = {k: float(v) for k, v in metrics.items()}
                        rate = (step_count * cfg.data.batch_size
                                * cfg.data.crop_size ** 2 / 1e6
                                / (time.time() - t0))
                        self._log("train", {"epoch": epoch,
                                            "step": step_count,
                                            "MP/s": rate, **m})
                        if mesh.is_main:
                            for k, v in m.items():
                                self.logger.scalar_summary(k, v, step_count)
                    if (cfg.sample_interval
                            and step_count % cfg.sample_interval == 0):
                        # the current global batch against its bicubic twin
                        q = self._eval_step(batch, keep_sr=True)
                        sr = q.pop("sr")
                        sums = all_reduce_sums([v.sum() for v in q.values()],
                                               mesh)
                        n = cfg.data.batch_size
                        self._log("train", {"epoch": epoch,
                                            "step": step_count,
                                            **{k: float(v) / n for k, v
                                               in zip(q, sums.tolist())}})
                        if mesh.is_main:  # its first rows are the batch's
                            self._sample_summary(batch, sr, step_count)
                    if num_steps is not None and step_count >= num_steps:
                        return {k: float(v) for k, v in metrics.items()}
            finally:
                feed.close()
                self.feed_stats = {"epoch_s": time.time() - epoch_t0,
                                   "feed_wait_s": waited}

            # epoch end: parameter histograms; the validation sweep feeds
            # the plateau policy, so it covers the whole test set unless
            # cfg.val_max_batches caps it
            if mesh.is_main:
                self._param_histograms(step_count)
            val = self.validate(max_batches=cfg.val_max_batches)
            last_metrics = val
            self._log("val", {"epoch": epoch, **val})
            for k in ("loss_G", "loss_D"):
                if k in metrics:
                    self.history[k].append(float(metrics[k]))
            for k in ("psnr", "ssim", "ergas"):
                self.history[k].append(val[k])
            # The reference's elif chain: only the first improving metric
            # updates its stored best, and any improvement resets the
            # counter and marks this epoch best.  LPIPS, where the sweep
            # has it, stays out of the chain, as in the JAX trainer.
            improved = True
            if val["psnr"] > best["psnr"]:
                best["psnr"] = val["psnr"]
            elif val["ssim"] > best["ssim"]:
                best["ssim"] = val["ssim"]
            elif val["ergas"] < best["ergas"]:
                best["ergas"] = val["ergas"]
            else:
                improved = False
            if improved:
                bad_epochs = 0
                best_epoch = epoch
                self._save_best(best_path)
            else:
                bad_epochs += 1
            if (cfg.optim.step_decay_epochs
                    and (epoch + 1) % cfg.optim.step_decay_epochs == 0):
                set_lr(self.g_opt,
                       get_lr(self.g_opt) * cfg.optim.step_decay_gamma)

            if (epoch + 1) % cfg.save_epochs == 0:
                self.save_checkpoint(epoch)
            epoch += 1

            if bad_epochs >= cfg.optim.plateau_patience:
                # Plateau backtrack: reload the best G; halve the G lr
                # always, the D lr only once the lr before the halving is
                # under 1e-4; rewind the epoch counter to just after the
                # best epoch and pop the stale metric history (the loss
                # curves stay, as in the reference).  Every rank reads what
                # rank 0 wrote before the barrier in _save.
                if os.path.exists(best_path):
                    prev = torch.load(best_path, map_location=self.device,
                                      weights_only=True)
                    self.generator.load_state_dict(prev["generator"])
                    self._replicate()
                    self._drop_graph()
                elif mesh.is_main:
                    print("plateau: no best checkpoint yet "
                          "(no finite-improvement epoch so far)")
                cur_lr = get_lr(self.g_opt)
                set_lr(self.g_opt, cur_lr * 0.5)
                if self.d_opt is not None and cur_lr < 1e-4:
                    set_lr(self.d_opt, get_lr(self.d_opt) * 0.5)
                bad_epochs = 0
                if mesh.is_main:
                    print(f"plateau: reloaded best, lr -> "
                          f"{cur_lr * 0.5:.2e}")
                if cfg.optim.plateau_rewind:
                    epoch = best_epoch + 1
                    for k in ("psnr", "ssim", "ergas"):
                        hist = self.history[k]
                        del hist[len(hist) - min(cfg.optim.plateau_patience,
                                                 len(hist)):]
        if mesh.is_main:
            plot_curves(self.history,
                        os.path.join(cfg.model_dir, "train_curves.png"))
        return last_metrics

    # ------------------------------------------------------------------
    def save_checkpoint(self, epoch: int,
                        include_optimizer: bool = False) -> str:
        """G and D weights (D's running statistics included) and the step
        count into ``cfg.model_dir``; optimizer states on request.  Rank 0
        writes; every rank returns the path once the file is there."""
        os.makedirs(self.cfg.model_dir, exist_ok=True)
        path = os.path.join(self.cfg.model_dir, f"ckpt_epoch_{epoch}.pt")
        state = {"generator": self.generator.state_dict(), "step": self.step}
        if self.discriminator is not None:
            state["discriminator"] = self.discriminator.state_dict()
        if include_optimizer:
            state["g_opt"] = self.g_opt.state_dict()
            if self.d_opt is not None:
                state["d_opt"] = self.d_opt.state_dict()
        self._save(state, path)
        return path

    def load_checkpoint(self, path: str) -> None:
        """Restore what :meth:`save_checkpoint` wrote (rank 0's copy on
        every rank)."""
        self._drop_graph()
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.generator.load_state_dict(state["generator"])
        if self.discriminator is not None and "discriminator" in state:
            self.discriminator.load_state_dict(state["discriminator"])
        for key, opt in (("g_opt", self.g_opt), ("d_opt", self.d_opt)):
            if opt is not None and key in state:
                opt.load_state_dict(state[key])
                set_capturable(opt, self.graphed)
        self.step = state["step"]
        self._replicate()

