"""Diffusion SR trainer: the GDP_x0 DDPM wrapper in PyTorch.

Counterpart of ``sradsgan_tpu/diffusion/trainer.py`` (the reference's
GDP_x0 ``model/model.py:12-168`` and ``sr_mfe.py``'s step loop): Adam on
the x0-prediction loss, sampling by the 1000-step ancestral chain, the
validation sweep against the bicubic twin, checkpoints with the optimizer
state.

Data: the shared pipeline's (lr, hr, bc) triplets in [0, 1] become GDP's
``HR = 2 hr - 1`` and ``SR = 2 bc - 1`` (GDP normalizes to [-1, 1] and
conditions on the bicubic re-upsample, GDP_x0/data/LRHR_dataset.py).

Precision: float32 (``bf16=False``), or bfloat16 autocast over float32
weights (the default, as the JAX ``dtype=bfloat16`` over float32 params);
the loss and the chain's arithmetic stay float32 either way.

Randomness: the weights from ``seed`` (``unet.flax_init``), the training
draws from a ``torch.Generator`` on the device seeded 1 at each
:meth:`train` call, a sample's from one seeded with the step count unless
the caller hands one in; the JAX package draws from ``PRNGKey``s of the same
seeds, so the two agree only where a test hands both the same ``t`` and
noise (:meth:`train_step`'s ``t`` and ``noise``).

Data parallelism (``num_devices``; ``parallel/mesh.py``), as in the GAN
trainer: under ``torchrun`` each rank steps on its rows of the global batch
(``data_cfg.batch_size``), ``t`` and the noise are drawn for the global
batch from the same seeded generator on every rank and sliced alike, the
gradients are averaged over the ranks, the logged loss is the mean over the
ranks, and rank 0 alone writes.  GroupNorm normalizes each image alone, so
the UNet needs no other collective, and with dropout 0 (every shipped
config) W ranks take the one-process step at the global batch.  With
dropout, each rank draws its own masks.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from sradsgan_tpu_torch.config import DataConfig
from sradsgan_tpu_torch.data.datasets import (build_test_dataset,
                                              build_train_dataset)
from sradsgan_tpu_torch.data.loader import DataLoader, device_prefetch
from sradsgan_tpu_torch.diffusion.gaussian import (Schedule,
                                                   draw_timesteps_and_noise,
                                                   p_losses_given,
                                                   p_sample_chain,
                                                   p_sample_loop)
from sradsgan_tpu_torch.diffusion.unet import UNet
from sradsgan_tpu_torch.metrics.fidelity import (compare_ergas, compare_mse,
                                                 compare_psnr, compare_ssim,
                                                 tensor_to_uint8)
from sradsgan_tpu_torch.parallel.mesh import (all_reduce_grads_,
                                              all_reduce_sums, create_mesh,
                                              replicate, shard_batch)
from sradsgan_tpu_torch.utils.logging import Logger


def _tif_writer():
    """cv2's ``imwrite``, or None (with a note on stderr) where cv2 does
    not import."""
    try:
        import cv2
    except ImportError:
        print("validate: cv2 does not import here; no .tif dumps written",
              file=sys.stderr)
        return None
    return cv2.imwrite


class DiffusionTrainer:
    def __init__(self, data_cfg: DataConfig, scale: int,
                 save_dir: str = "Result/GDP",
                 schedule: str = "linear", n_timestep: int = 1000,
                 linear_start: float = 1e-4, linear_end: float = 2e-2,
                 lr: float = 1e-4, unet_kwargs: Optional[dict] = None,
                 bf16: bool = True, seed: int = 0,
                 device: torch.device | str = "cuda", num_devices: int = -1):
        if (torch.device(device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                f"DiffusionTrainer(device={str(device)!r}) needs a CUDA "
                "device and this torch sees none; pass device='cpu' to run "
                "on the CPU")
        self.mesh = create_mesh(num_devices, device)
        self.device = self.mesh.device
        self.data_cfg = data_cfg
        self.scale = scale
        self.save_dir = save_dir
        self.bf16 = bf16
        self.sched = Schedule.create(schedule, n_timestep, linear_start,
                                     linear_end)
        self.logger = Logger("gdp", os.path.join(save_dir, "logs"))
        unet_kwargs = dict(unet_kwargs or {})
        unet_kwargs.setdefault("image_size", data_cfg.crop_size)
        self.unet = replicate(UNet(**unet_kwargs, seed=seed,
                                   device=self.device), self.mesh)
        # optax.adam's defaults
        self.opt = torch.optim.Adam(self.unet.parameters(), lr=lr,
                                    betas=(0.9, 0.999), eps=1e-8)
        self.step = 0

    # ------------------------------------------------------------------
    def denoise(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The UNet in the trainer's precision."""
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.bf16):
            return self.unet(x, t)

    def _to_device(self, x) -> torch.Tensor:
        """An NHWC numpy array or an NCHW tensor -> NCHW on the device in
        the UNet's parameter dtype."""
        dtype = next(self.unet.parameters()).dtype
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype).contiguous()
        t = torch.from_numpy(np.asarray(x, np.float32)).to(self.device, dtype)
        return t.permute(0, 3, 1, 2).contiguous()

    def train_step(self, batch: Mapping[str, Any],
                   generator: Optional[torch.Generator] = None,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One Adam step on the global batch ``{"HR": x0, "SR":
        conditioner}`` in [-1, 1] (NHWC numpy or NCHW tensors), of which
        this rank takes its rows; ``t`` (B,) and the noise (like the batch)
        drawn from ``generator`` unless both are given, for the global
        batch either way.  Returns the loss, the mean over the ranks (a
        float32 tensor, not synchronized)."""
        if t is not None and noise is not None:
            t, noise = shard_batch(t, self.mesh), shard_batch(noise, self.mesh)
        else:
            t = noise = None
        return self._local_step(shard_batch(dict(batch), self.mesh),
                                generator, t, noise)

    def _local_step(self, batch: Mapping[str, Any],
                    generator: Optional[torch.Generator],
                    t=None, noise=None) -> torch.Tensor:
        """:meth:`train_step` on this rank's rows (and, where given, their
        ``t`` and noise)."""
        mesh = self.mesh
        x0 = self._to_device(batch["HR"])
        cond = self._to_device(batch["SR"])
        if t is None or noise is None:  # the global batch's, this rank's rows
            t, noise = draw_timesteps_and_noise(
                self.sched, x0[:1].expand(x0.shape[0] * mesh.world, -1, -1,
                                          -1), generator)
            t, noise = t[mesh.rank::mesh.world], noise[mesh.rank::mesh.world]
        self.unet.train()
        loss = p_losses_given(self.denoise, self.sched, x0, cond,
                              torch.as_tensor(t, device=self.device).long(),
                              self._to_device(noise))
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads_(self.unet.parameters(), mesh)
        self.opt.step()
        return (all_reduce_sums([loss], mesh)[0]
                / mesh.world).to(loss.dtype)

    def train(self, n_iter: int, val_freq: int = 0,
              log_freq: int = 50) -> float:
        """Steps until ``self.step`` reaches ``n_iter``, the loader rebuilt
        on each pass with ``seed=self.step`` (each rank on its shard); a log
        line every ``log_freq`` steps, ``validate(4)`` every ``val_freq``
        (on every rank; rank 0 logs).  Returns the last loss."""
        mesh = self.mesh
        batch_size = self.data_cfg.batch_size
        if batch_size % mesh.world:
            raise ValueError(f"batch_size {batch_size} (the global batch) "
                             f"does not split over {mesh.world} ranks")
        ds = build_train_dataset(self.data_cfg, self.scale)
        generator = torch.Generator(self.device).manual_seed(1)
        loss = None
        t0 = time.time()
        while self.step < n_iter:
            loader = DataLoader(ds, batch_size // mesh.world, shuffle=True,
                                num_workers=self.data_cfg.num_workers,
                                seed=self.step, shard_index=mesh.rank,
                                shard_count=mesh.world)
            feed = device_prefetch(iter(loader), self.device)
            for batch in feed:
                gdp_batch = {"HR": 2.0 * batch["hr"] - 1.0,
                             "SR": 2.0 * batch["bc"] - 1.0}
                loss = self._local_step(gdp_batch, generator)
                self.step += 1
                if self.step % log_freq == 0 and mesh.is_main:
                    self.logger.print_format_results(
                        "train", {"iter": self.step, "loss": float(loss),
                                  "it/s": self.step / (time.time() - t0)})
                if val_freq and self.step % val_freq == 0:
                    val = self.validate(max_images=4)
                    if mesh.is_main:
                        self.logger.print_format_results(
                            "val", {"iter": self.step, **val})
                if self.step >= n_iter:
                    break
            feed.close()
        return float(loss) if loss is not None else float("nan")

    # ------------------------------------------------------------------
    def _cond(self, bc01: np.ndarray):
        """Bicubic [0, 1] NHWC -> the NCHW conditioner in [-1, 1] on the
        device, reflect-padded to a multiple of the UNet's total
        downsampling factor, and the size to crop back to."""
        mult = self.unet.size_multiple
        _, h, w, _ = bc01.shape
        ph, pw = (mult - h % mult) % mult, (mult - w % mult) % mult
        padded = np.pad(bc01, ((0, 0), (0, ph), (0, pw), (0, 0)),
                        mode="reflect") if (ph or pw) else bc01
        cond = torch.from_numpy(np.ascontiguousarray(padded, np.float32))
        cond = cond.to(self.device).permute(0, 3, 1, 2) * 2.0 - 1.0
        return cond.contiguous(), (h, w)

    def _sample_generator(self, generator):
        if generator is not None:
            return generator
        return torch.Generator(self.device).manual_seed(self.step)

    def super_resolution(self, bc01: np.ndarray,
                         generator: Optional[torch.Generator] = None
                         ) -> np.ndarray:
        """Bicubic-upsampled LR in [0, 1], NHWC -> the sampled SR in [0, 1]
        (unclipped, as JAX returns it), NHWC float32.  Any H, W: the input
        is reflect-padded to a multiple of the UNet's total downsampling
        factor and the output cropped back."""
        cond, (h, w) = self._cond(bc01)
        self.unet.eval()
        out = p_sample_loop(self.denoise, self.sched, cond,
                            self._sample_generator(generator))
        out = ((out + 1.0) * 0.5).permute(0, 2, 3, 1)
        return out[:, :h, :w].cpu().numpy()

    def super_resolution_chain(self, bc01: np.ndarray,
                               n_snapshots: int = 10,
                               generator: Optional[torch.Generator] = None
                               ) -> np.ndarray:
        """Continuous sampling: the reverse chain's snapshots (reference
        sr_mfe.py:275-403), clipped to [0, 1], (n_snapshots + 1, B, H, W,
        C)."""
        cond, (h, w) = self._cond(bc01)
        self.unet.eval()
        chain = p_sample_chain(self.denoise, self.sched, cond,
                               self._sample_generator(generator),
                               n_snapshots)
        chain = ((chain + 1.0) * 0.5).clamp(0, 1).permute(0, 1, 3, 4, 2)
        return chain[:, :, :h, :w].cpu().numpy()

    @classmethod
    def from_gdp_config(cls, path_or_name: str, data_cfg: DataConfig,
                        save_dir: str = "Result/GDP", **overrides):
        """A trainer from a GDP-style JSON config (``diffusion/config.py``);
        ``overrides`` replace its arguments."""
        from sradsgan_tpu_torch.diffusion.config import (
            load_gdp_config, trainer_kwargs_from_config)
        kwargs = trainer_kwargs_from_config(load_gdp_config(path_or_name))
        kwargs.update(overrides)
        return cls(data_cfg, save_dir=save_dir, **kwargs)

    def validate(self, max_images: int = 4,
                 result_dir: Optional[str] = None,
                 continuous: bool = False,
                 n_snapshots: int = 8) -> Dict[str, float]:
        """The metric suite against the bicubic twin (reference
        sr_mfe.py:124-261): MSE, PSNR, SSIM, ERGAS and LPIPS (``lpips``, or
        ``lpips*`` with the seeded trunk, ``losses/lpips.py``) of the
        sampled SR and of the bicubic baseline, means over the first
        ``max_images`` test images.  With ``result_dir``: per image the
        hr/sr/lr/inf ``.tif`` dumps (where cv2 imports) and the annotated
        HR/LR/Bicubic/SR panel ``{step}_{idx}_plot.png`` (where matplotlib
        imports); ``continuous`` samples the reverse chain's snapshots and
        draws them as ``{step}_{idx}_sr_process.png`` (sr_mfe.py:305-319).
        A dump whose library does not import is left out with a note on
        stderr."""
        from sradsgan_tpu_torch.losses.lpips import (lpips_fn,
                                                     lpips_is_calibrated)
        from sradsgan_tpu_torch.utils.plotting import (plot_chain_grid,
                                                       plot_test_panel)
        ds = build_test_dataset(self.data_cfg, self.scale)
        loader = DataLoader(ds, min(max_images, 4), shuffle=False,
                            drop_last=False, num_workers=2)
        lpips = lpips_fn()
        lpips_key = "lpips" if lpips_is_calibrated() else "lpips*"
        imwrite = None
        if result_dir:
            os.makedirs(result_dir, exist_ok=True)
            imwrite = _tif_writer()
        rows = []
        seen = 0
        for batch in loader:
            chain = None
            if continuous:
                chain = self.super_resolution_chain(batch["bc"],
                                                    n_snapshots=n_snapshots)
                sr = chain[-1]
            else:
                sr = self.super_resolution(batch["bc"])
            for i in range(sr.shape[0]):
                if seen >= max_images:
                    break
                seen += 1
                sr_u8 = tensor_to_uint8(sr[i])
                hr_u8 = tensor_to_uint8(batch["hr"][i])
                bc_u8 = tensor_to_uint8(batch["bc"][i])
                row = {
                    "mse": compare_mse(sr_u8, hr_u8),
                    "psnr": compare_psnr(sr_u8, hr_u8),
                    "ssim": compare_ssim(sr_u8, hr_u8),
                    "ergas": compare_ergas(hr_u8, sr_u8, self.scale),
                    lpips_key: lpips(sr[i], batch["hr"][i]),
                    "bc_mse": compare_mse(bc_u8, hr_u8),
                    "bc_psnr": compare_psnr(bc_u8, hr_u8),
                    "bc_ssim": compare_ssim(bc_u8, hr_u8),
                    "bc_ergas": compare_ergas(hr_u8, bc_u8, self.scale),
                    "bc_" + lpips_key: lpips(batch["bc"][i],
                                             batch["hr"][i]),
                }
                rows.append(row)
                if not result_dir:
                    continue
                stem = os.path.join(result_dir, f"{self.step}_{seen}")
                if imwrite is not None:
                    lr_u8 = tensor_to_uint8(batch["lr"][i])
                    for name, img in (("hr", hr_u8), ("sr", sr_u8),
                                      ("lr", lr_u8), ("inf", bc_u8)):
                        imwrite(f"{stem}_{name}.tif",
                                img[..., ::-1])  # RGB -> cv2 BGR
                keys = ("mse", "psnr", "ssim", "ergas")
                plot_test_panel(
                    [batch["hr"][i], batch["lr"][i], batch["bc"][i], sr[i]],
                    ["HR", "LR", "Bicubic", "SR"],
                    [None, None, {k: row["bc_" + k] for k in keys},
                     {k: row[k] for k in keys}], f"{stem}_plot.png")
                if chain is not None:
                    plot_chain_grid(chain[:, i], f"{stem}_sr_process.png")
            if seen >= max_images:
                break
        return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}

    # ------------------------------------------------------------------
    def save_checkpoint(self, tag: str = "latest") -> str:
        """Save the UNet's weights, the Adam state and the step (the
        reference saves gen + opt so a long run resumes exactly,
        GDP_x0/model/model.py:126-146) to ``gdp_ckpt_{tag}.pt``: rank 0
        writes, and every rank returns the path once the file is there."""
        path = os.path.join(self.save_dir, f"gdp_ckpt_{tag}.pt")
        if self.mesh.is_main:
            os.makedirs(self.save_dir, exist_ok=True)
            torch.save({"unet": self.unet.state_dict(),
                        "optimizer": self.opt.state_dict(),
                        "step": self.step}, path)
        self.mesh.barrier()
        return path

    def load_checkpoint(self, path: str) -> None:
        """Restore the weights, the Adam state and the step counter
        (GDP_x0/model/model.py:148-168 resume_state)."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.unet.load_state_dict(state["unet"])
        self.opt.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        replicate(self.unet, self.mesh)
