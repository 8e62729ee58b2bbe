"""Optional Weights & Biases logging.

Counterpart of ``sradsgan_tpu/utils/wandb_logger.py`` (reference
GDP_x0/core/wandb_logger.py): metrics, images and checkpoints go to a wandb
run where ``wandb`` imports and ``wandb.init`` succeeds; otherwise every
call does nothing, so callers may log unconditionally.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class WandbLogger:
    def __init__(self, project: str = "sradsgan_tpu",
                 config: Optional[Dict[str, Any]] = None, **kwargs):
        try:
            import wandb
            self._run = wandb.init(project=project, config=config, **kwargs)
            self._wandb = wandb
        except Exception:
            self._run = None
            self._wandb = None

    @property
    def enabled(self) -> bool:
        return self._run is not None

    def log_metrics(self, metrics: Dict[str, float],
                    step: Optional[int] = None) -> None:
        if self._run is not None:
            self._run.log(metrics, step=step)

    def log_image(self, key: str, image, step: Optional[int] = None) -> None:
        if self._run is not None:
            self._run.log({key: self._wandb.Image(image)}, step=step)

    def log_checkpoint(self, path: str) -> None:
        if self._run is not None:
            self._run.save(path)

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()
