"""Class-based trainer facade (port of ``latte_tpu/train/trainer.py``).

A class with ``fit`` / ``resume`` over the same loop as
:func:`latte_tpu_torch.train.train.main`, with its callbacks
(:mod:`latte_tpu_torch.train.callbacks`: on_train_start, on_log,
on_checkpoint, on_train_end, should_stop). Runs on ``cuda`` unless given
``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Optional

from latte_tpu_torch.config import Config, load_config

__all__ = ["Trainer"]


class Trainer:
    """Usage::

        trainer = Trainer(max_steps=10_000, ckpt_every=1_000)
        result = trainer.fit("configs/ucf101/ucf101_train.yaml")  # a path or a Config
    """

    def __init__(
        self,
        max_steps: Optional[int] = None,
        ckpt_every: Optional[int] = None,
        log_every: Optional[int] = None,
        results_dir: Optional[str] = None,
        callbacks=None,
        device: Optional[str] = None,
    ):
        self.callbacks = list(callbacks or [])
        self.device = device
        self._overrides: Dict = {}
        if max_steps is not None:
            self._overrides["max_train_steps"] = int(max_steps)
        if ckpt_every is not None:
            self._overrides["ckpt_every"] = int(ckpt_every)
        if log_every is not None:
            self._overrides["log_every"] = int(log_every)
        if results_dir is not None:
            self._overrides["results_dir"] = str(results_dir)

    def _resolve(self, config) -> Config:
        if isinstance(config, str):
            config = load_config(config)
        cfg = Config(dict(config))
        cfg.update(self._overrides)
        return cfg

    def fit(self, config) -> Dict:
        from latte_tpu_torch.train.train import main

        return main(self._resolve(config), callbacks=self.callbacks, device=self.device)

    def resume(self, config, checkpoint: str) -> Dict:
        from latte_tpu_torch.train.train import main

        cfg = self._resolve(config)
        cfg.resume_from_checkpoint = checkpoint
        return main(cfg, callbacks=self.callbacks, device=self.device)
