"""GDP conditional diffusion super-resolution (counterpart of
``sradsgan_tpu/diffusion/``): the UNet denoiser (``unet.py``), the
x0-prediction DDPM (``gaussian.py``), GDP's JSON configs (``config.py``)
and ``DiffusionTrainer`` (``trainer.py``)."""
